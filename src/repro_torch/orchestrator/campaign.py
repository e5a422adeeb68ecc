"""Campaigns: grids of sessions (the paper's protocol, orchestrated).

The paper's study shape — every tuner × every benchmark × repeated seeds ×
multiple architectures — is a Cartesian product of sessions.  A
:class:`Campaign` materializes that product as specs and runs them through
the session runner; with a store, a killed campaign resumes where it
stopped: finished sessions are skipped via their published traces, the
interrupted one continues from its journal.

Three schedulers:

* **serial** (`Campaign.run`, the original): sessions run one at a time,
  each against its own worker pool.
* **interleaved** (:func:`run_campaign`, ``Campaign.run(interleave=True)``):
  every session becomes a :func:`~repro_torch.orchestrator.runner.session_stepper`
  coroutine and ONE shared :class:`WorkerPool` answers their evaluation
  requests round-robin.  Sessions over the same problem share a compiled
  space, one warm executor, and an evaluation cache; for portability grids
  (same problem, several architectures) the cache is *arch-shared*: each
  deduped row is evaluated once via
  ``WorkerPool.evaluate_rows(rows, archs=...)`` — one decode + one set of
  value columns feeding every architecture — and all sibling sessions read
  their column.  Trajectories and journals are identical to the serial
  scheduler by construction: a stepper only ever sees the objectives of the
  rows it asked for, and those are bit-identical however they were batched
  (the compiled-path equivalence property).
* **broker / async tell** (``run_campaign(..., broker=...)``): evaluation
  leaves the process entirely.  The scheduler publishes each round's
  merged missing (row, arch) needs as jobs on a durable
  :class:`~repro_torch.orchestrator.broker.Broker` and keeps stepping *other*
  sessions while a detached worker fleet (``python -m repro_torch.orchestrator
  worker``) serves them; each stepper is told only when its own batch is
  complete.  Because a stepper's request/tell order is sequential by
  construction and objectives are bit-identical however they are batched
  or routed, trajectories, journals, and published traces equal the
  serial loop's — worker count, arrival order, and kill/requeue events
  never leak into rng streams (property-tested in
  ``tests/test_broker.py``).

A group that mixes the device's arch (measured) with the cost model's ids
keeps them apart: the device's rows are measured, each once for every
session of the group, in the pool's measuring processes; the model's ids
share one columnar sweep.  A measured row never reaches the model's
endpoints, and a model row never launches a kernel
(:func:`_partition_archsets`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

from ..core.problem import DEFAULT_ARCH, TunableProblem
from ..core.tuners.base import TuneResult
from ..telemetry.trace import span
from .broker import Broker, decode_trials
from .registry import make_problem, problem_names
from .session import CAMPAIGN_TUNER_DEFAULTS, DONE, SessionSpec
from .store import SessionStore
from .runner import (EvalRequest, resolve_session, run_session,
                     session_stepper)
from .workers import WorkerPool, measures


def run_campaign(specs: Sequence[SessionSpec],
                 store: SessionStore | None = None, *,
                 pool: WorkerPool | None = None,
                 workers: int = 4, mode: str = "auto", max_retries: int = 2,
                 share_archs: bool = True,
                 problems: dict | None = None,
                 broker: Broker | None = None, poll_s: float = 0.02,
                 on_session: Callable[[SessionSpec, TuneResult], None] | None
                 = None) -> dict[str, TuneResult]:
    """Interleave every session of ``specs`` on one shared worker pool.

    Returns ``{session_id: trace}`` (specs order).  ``problems`` optionally
    maps ``spec.share_key`` (or problem name) to a live
    :class:`TunableProblem` instance — one instance is shared by every
    session of that problem either way, so the compiled table, the CSR
    neighbor structure, and the evaluation cache are built once per problem
    for the whole grid.

    ``share_archs=True`` turns same-problem multi-arch grids into
    portability campaigns: a row proposed by ANY sibling session is
    evaluated on all of the group's architectures in one shared-columns
    sweep, cached, and never evaluated again by anyone.  Per-session
    journals, budget accounting, and trajectories are exactly those of
    serial ``run_session`` runs.

    ``workers`` sizes the one shared pool (spec-level worker counts are a
    per-session setting and do not apply here; trajectories never depend
    on parallelism either way).  ``mode="auto"`` resolves per evaluation:
    the device's arch in the pool's measuring processes (one per device),
    the cost model's ids and function problems in its threads.

    With ``broker=``, evaluation is dispatched to a durable job queue
    served by detached worker processes instead of an in-process pool, and
    tells become *asynchronous*: sessions whose batches are still in
    flight wait while every other session keeps stepping.  Trajectories,
    journals, and published traces are bit-identical to the in-process
    schedulers.  ``workers``/``mode``/``max_retries`` configure the worker
    fleet, not the driver, and are ignored here; every ``spec.problem``
    must be a registry name (and ``problems=`` presets are rejected) so
    driver and workers provably evaluate the same problem.
    """
    specs = list(specs)
    if not specs:
        return {}
    if broker is not None:
        if pool is not None:
            raise ValueError("pass either pool= or broker=, not both")
        return _run_campaign_broker(specs, store, broker,
                                    share_archs=share_archs,
                                    problems=problems, poll_s=poll_s,
                                    on_session=on_session)
    problems = dict(problems or {})

    # one live problem per share-group (shared compiled space + cache)
    live_problems: dict[tuple, TunableProblem] = {}
    for spec in specs:
        key = spec.share_key
        if key in live_problems:
            continue
        preset = problems.get(key, problems.get(spec.problem))
        live_problems[key] = preset if preset is not None else \
            make_problem(spec.problem, **spec.problem_kwargs)

    groups: dict[tuple, dict] = {}
    for spec in specs:
        g = groups.setdefault(spec.share_key,
                              {"archs": [], "cache": {}})
        if spec.arch not in g["archs"]:
            g["archs"].append(spec.arch)

    own_pool = pool is None
    if pool is None:
        first = live_problems[specs[0].share_key]
        pool = WorkerPool(first, specs[0].arch, workers=workers, mode=mode,
                          max_retries=max_retries)

    sessions: list[dict] = []
    out: dict[str, TuneResult] = {}
    try:
        for spec in specs:
            problem = live_problems[spec.share_key]
            _, tuner = resolve_session(spec, problem, None)
            gen = session_stepper(spec, problem=problem, tuner=tuner,
                                  store=store)
            sessions.append({"spec": spec, "gen": gen, "req": None,
                             "done": False})

        # prime: advance every stepper to its first evaluation request
        for s in sessions:
            _advance(s, None, out, on_session)

        # rounds: gather every live session's pending request, evaluate each
        # group's union of missing rows in ONE arch-shared pool call, then
        # answer all requests from the cache.  Merging across sessions makes
        # the evaluation batches bigger (deeper into the columnar regime)
        # and dedups rows proposed by several sibling sessions in the same
        # round; per-session results are bit-identical either way.
        while any(not s["done"] for s in sessions):
            pending = [s for s in sessions
                       if not s["done"] and s["req"] is not None]
            with span("campaign.round", cat="campaign",
                      sessions=len(pending)):
                for key, need in _round_missing(pending, groups).items():
                    anchor = next(s for s in pending
                                  if s["spec"].share_key == key)
                    try:
                        _fill_cache(need, groups[key], anchor["req"].problem,
                                    pool, share_archs)
                    except BaseException as e:
                        anchor["gen"].throw(e)
                        raise          # pragma: no cover — throw re-raises
                for s in pending:
                    req: EvalRequest = s["req"]
                    if req.configs is not None:   # dict path: no row cache
                        try:
                            trials = pool.evaluate(req.configs,
                                                   arch=req.arch,
                                                   problem=req.problem)
                        except BaseException as e:
                            s["gen"].throw(e)
                            raise      # pragma: no cover — throw re-raises
                    else:
                        cache = groups[s["spec"].share_key]["cache"]
                        trials = [cache[r][req.arch] for r in req.rows]
                    _advance(s, trials, out, on_session)
    finally:
        for s in sessions:
            if not s["done"]:
                s["gen"].close()       # marks the session FAILED, journal kept
        if own_pool:
            pool.close()

    return {s["spec"].session_id: out[s["spec"].session_id]
            for s in sessions}


def _advance(s: dict, trials, out: dict, on_session) -> None:
    """Send ``trials`` into a session stepper (or prime it) and record
    either its next request or its finished trace."""
    try:
        s["req"] = next(s["gen"]) if trials is None else s["gen"].send(trials)
    except StopIteration as e:
        s["done"], s["req"] = True, None
        out[s["spec"].session_id] = e.value
        if on_session is not None:
            on_session(s["spec"], e.value)


def _round_missing(pending: list[dict], groups: dict) -> dict:
    """Per share-group ``{(row, arch)`` set as ordered row/arch needs}`` for
    one scheduling round: every (row, arch) some pending row-request wants
    that the group cache cannot answer yet, rows in first-proposal order."""
    need: dict[tuple, dict[int, set]] = {}
    for s in pending:
        req: EvalRequest = s["req"]
        if req.configs is not None:
            continue
        key = s["spec"].share_key
        cache = groups[key]["cache"]
        rows = need.setdefault(key, {})
        for r in req.rows:
            if req.arch not in cache.get(r, ()):
                rows.setdefault(r, set()).add(req.arch)
    return {k: v for k, v in need.items() if v}


def _partition_archsets(need: dict[int, set], group_archs: list[str],
                        share_archs: bool,
                        problem: TunableProblem | None = None
                        ) -> dict[tuple, list[int]]:
    """Partition one group's missing ``{row: wanted archs}`` into
    evaluation batches: ``{archset: rows}``, rows in first-proposal order,
    archsets in the group's canonical arch order.

    The one batching policy both schedulers share (in-process
    :func:`_fill_cache` sweeps each batch directly; the broker driver
    submits each as a job), so the arch-shared grouping can never drift
    between them.  With ``share_archs`` off — or a single-arch group —
    every batch is single-arch.  An arch that ``problem`` measures (the
    device's id) always takes a batch of its own: a measurement belongs to
    one device, and the cost model's shared sweep refuses its id.
    """
    solo = {a for a in group_archs
            if problem is not None and measures(problem, a)}
    by_archset: dict[tuple, list[int]] = {}
    if share_archs and len(group_archs) > 1:
        for r, want in need.items():
            aset = tuple(a for a in group_archs if a in want and a not in solo)
            if aset:
                by_archset.setdefault(aset, []).append(r)
            for a in group_archs:
                if a in want and a in solo:
                    by_archset.setdefault((a,), []).append(r)
    else:
        for r, want in need.items():
            for a in want:
                by_archset.setdefault((a,), []).append(r)
    return by_archset


def _fill_cache(need: dict[int, set], group: dict, problem, pool: WorkerPool,
                share_archs: bool) -> None:
    """Evaluate one group's missing (row, arch) pairs and populate its
    cache.

    Arch-shared mode sweeps each row once for every architecture that
    still needs it (the common portability-grid case: all sibling sessions
    propose a row in the same round, so the whole group reads one
    shared-columns sweep).  Only *missing* archs are swept — a resumed
    campaign whose journals already cover (row, arch) pairs never
    re-evaluates them — so no (row, arch) is ever evaluated twice
    campaign-wide.
    """
    cache: dict[int, dict] = group["cache"]
    for archset, rows in _partition_archsets(need, group["archs"],
                                             share_archs, problem).items():
        if len(archset) > 1:
            per_arch = pool.evaluate_rows(rows, archs=archset,
                                          problem=problem)
        else:
            per_arch = {archset[0]: pool.evaluate_rows(
                rows, arch=archset[0], problem=problem)}
        for j, r in enumerate(rows):
            cache.setdefault(r, {}).update(
                {a: per_arch[a][j] for a in archset})


# --------------------------------------------------------------------- #
# broker scheduler: async tell over a durable job queue
# --------------------------------------------------------------------- #
def _check_broker_specs(specs: list[SessionSpec],
                        store: SessionStore | None,
                        problems: dict | None) -> None:
    """Fail fast on grids a worker fleet cannot serve faithfully."""
    if problems:
        # workers ALWAYS rematerialize problems from the registry by
        # name; honoring a driver-side instance here would let a custom
        # instance silently disagree with what the fleet evaluates
        raise ValueError(
            "broker campaigns take no problems= presets — workers "
            "rematerialize every problem from the registry by name, so a "
            "live driver-side instance could silently diverge from what "
            "the fleet evaluates")
    names = set(problem_names())
    bad = sorted({s.problem for s in specs} - names)
    if bad:
        raise ValueError(
            f"broker campaigns need registry problems (workers materialize "
            f"them by name); unknown: {', '.join(bad)}")
    if store is None:
        return
    for spec in specs:
        sid = spec.session_id
        if store.exists(sid) and store.journal_version(sid) == 1:
            raise RuntimeError(
                f"session {sid} in store {store.root} has a v1 "
                f"(config-column) journal — this store was last written by "
                f"an older orchestrator.  Broker campaigns require "
                f"row-native (v2) journals; finish the session in-process "
                f"first (`python -m repro_torch.orchestrator resume {sid} "
                f"--store {store.root}`) or start a fresh store.")


def _run_campaign_broker(specs: list[SessionSpec],
                         store: SessionStore | None, broker: Broker, *,
                         share_archs: bool, problems: dict | None,
                         poll_s: float,
                         on_session) -> dict[str, TuneResult]:
    """Drive every stepper against a durable job queue, telling each one
    as soon as (and only when) its own batch completes — async tell.

    The scheduling invariants that keep trajectories bit-identical to the
    serial loop:

    * a stepper's requests are answered in its own request order (it is a
      coroutine — there is no other order);
    * every (row, arch) is evaluated at most once campaign-wide: results
      land in the group cache, in-flight pairs are never resubmitted, and
      sibling sessions read the cached trial no matter which job carried
      it;
    * nothing about job routing, worker count, arrival order, or
      lease-requeue events reaches the tuners — they see only the
      objectives of the rows they asked for.
    """
    _check_broker_specs(specs, store, problems)
    live_problems: dict[tuple, TunableProblem] = {}
    for spec in specs:
        key = spec.share_key
        if key not in live_problems:
            # always the registry instance — exactly what workers build
            live_problems[key] = make_problem(spec.problem,
                                              **spec.problem_kwargs)

    groups: dict[tuple, dict] = {}
    for spec in specs:
        g = groups.setdefault(spec.share_key,
                              {"archs": [], "cache": {}, "spec": spec})
        if spec.arch not in g["archs"]:
            g["archs"].append(spec.arch)

    sessions: list[dict] = []
    out: dict[str, TuneResult] = {}
    in_flight: dict[tuple, int] = {}      # (share_key, row, arch) -> job id
    row_jobs: dict[int, dict] = {}        # job id -> {key, rows, archs, sids}
    cfg_jobs: dict[int, dict] = {}        # job id -> session state

    def _payload(spec: SessionSpec, archs, rows=None, configs=None,
                 sids=()) -> dict:
        p = {"problem": spec.problem, "pk": dict(spec.problem_kwargs),
             "archs": list(archs), "sessions": sorted(sids)}
        if rows is not None:
            p["rows"] = [int(r) for r in rows]
        else:
            space = live_problems[spec.share_key].space
            p["configs"] = [list(space.encode(c)) for c in configs]
        return p

    def _try_answer(s: dict) -> bool:
        """Advance ``s`` if its pending row request is fully cached."""
        req: EvalRequest = s["req"]
        if s["done"] or req is None or req.configs is not None:
            return False
        cache = groups[s["spec"].share_key]["cache"]
        if all(req.arch in cache.get(r, ()) for r in req.rows):
            _advance(s, [cache[r][req.arch] for r in req.rows],
                     out, on_session)
            return True
        return False

    def _pump_and_submit() -> None:
        """Step every session that can move, then publish the merged
        still-missing needs as broker jobs (the async-tell round)."""
        progressed = True
        while progressed:
            progressed = False
            for s in sessions:
                if _try_answer(s):
                    progressed = True
        # config-path sessions: one job per pending request
        for s in sessions:
            req: EvalRequest = s["req"]
            if (not s["done"] and req is not None
                    and req.configs is not None and s.get("job") is None):
                with span("broker.submit", cat="broker",
                          n=len(req.configs)):
                    jid = broker.submit(
                        _payload(s["spec"], [req.arch],
                                 configs=req.configs,
                                 sids=[s["spec"].session_id]))
                s["job"] = jid
                cfg_jobs[jid] = s
        # row-path sessions: merge missing (row, arch) pairs per group
        # (the same dedup-against-cache walk as the in-process
        # _round_missing, plus in-flight exclusion and per-pair
        # requester attribution for `status --broker`)
        need: dict[tuple, dict[int, set]] = {}
        requesters: dict[tuple, set] = {}       # (key, row, arch) -> sids
        late: dict[int, set] = {}               # in-flight job id -> new sids
        for s in sessions:
            req = s["req"]
            if s["done"] or req is None or req.configs is not None:
                continue
            sid = s["spec"].session_id
            key = s["spec"].share_key
            cache = groups[key]["cache"]
            for r in req.rows:
                if req.arch in cache.get(r, ()):
                    continue
                jid = in_flight.get((key, r, req.arch))
                if jid is None:
                    need.setdefault(key, {}).setdefault(r, set()) \
                        .add(req.arch)
                    requesters.setdefault((key, r, req.arch), set()).add(sid)
                elif sid not in row_jobs[jid]["sids"]:
                    # the pair is already riding another session's job:
                    # attach this sid so `status --broker` attributes the
                    # lease to it too
                    late.setdefault(jid, set()).add(sid)
        for key, rows_archs in need.items():
            g = groups[key]
            for aset, rows in _partition_archsets(
                    rows_archs, g["archs"], share_archs,
                    live_problems[key]).items():
                sids = set().union(*(requesters.get((key, r, a), set())
                                     for r in rows for a in aset))
                with span("broker.submit", cat="broker", n=len(rows),
                          archs=len(aset)):
                    jid = broker.submit(_payload(g["spec"], aset, rows=rows,
                                                 sids=sids))
                row_jobs[jid] = {"key": key, "rows": rows, "archs": aset,
                                 "sids": sids}
                in_flight.update({(key, r, a): jid
                                  for r in rows for a in aset})
        for jid, sids in late.items():
            row_jobs[jid]["sids"] |= sids
            broker.attach_sessions(jid, sorted(sids))

    def _ingest(jid: int, result: dict) -> None:
        """Land one finished job in the cache (row jobs) or its waiting
        session (config jobs)."""
        if jid in cfg_jobs:
            s = cfg_jobs.pop(jid)
            req: EvalRequest = s["req"]
            trials = decode_trials(result["arch_trials"][req.arch],
                                   req.arch, configs=req.configs)
            s["job"] = None
            _advance(s, trials, out, on_session)
            return
        if jid not in row_jobs:
            # a stale job from a previous driver run against this queue
            # (killed mid-campaign, its workers finished later): drop it —
            # this run resubmitted whatever it still needs
            return
        info = row_jobs.pop(jid)
        key = info["key"]
        space = live_problems[key].space
        cache = groups[key]["cache"]
        for a in info["archs"]:
            trials = decode_trials(result["arch_trials"][a], a,
                                   space=space, rows=info["rows"])
            for r, t in zip(info["rows"], trials):
                cache.setdefault(r, {})[a] = t
                in_flight.pop((key, r, a), None)

    def _fail(failures: list[dict]) -> None:
        """A job exhausted its attempts: every waiting session dies the
        way an in-process evaluation error would kill it — exception
        thrown into the generator (status FAILED, journal intact)."""
        msgs = [f"job {f['id']} failed after {f['attempts']} attempts: "
                f"{f['error']}" for f in failures]
        err = RuntimeError("broker campaign failed: " + "; ".join(msgs))
        for s in sessions:
            if not s["done"] and s["req"] is not None:
                try:
                    s["gen"].throw(err)
                except (RuntimeError, StopIteration):
                    s["done"] = True
        raise err

    try:
        for spec in specs:
            problem = live_problems[spec.share_key]
            _, tuner = resolve_session(spec, problem, None)
            gen = session_stepper(spec, problem=problem, tuner=tuner,
                                  store=store)
            sessions.append({"spec": spec, "gen": gen, "req": None,
                             "done": False, "job": None})
        for s in sessions:
            _advance(s, None, out, on_session)

        _pump_and_submit()
        while any(not s["done"] for s in sessions):
            with span("broker.collect", cat="broker"):
                done_jobs, failures = broker.collect()
            # failures of *our* jobs abort the campaign; stale failures
            # from a previous driver run are dropped like stale results
            failures = [f for f in failures
                        if f["id"] in row_jobs or f["id"] in cfg_jobs]
            if failures:
                _fail(failures)
            if not done_jobs:
                # nothing landed, so no session can have moved — idle
                # poll without re-walking every session's request
                time.sleep(poll_s)
                continue
            for jid in sorted(done_jobs):
                _ingest(jid, done_jobs[jid])
            _pump_and_submit()
    finally:
        for s in sessions:
            if not s["done"]:
                s["gen"].close()       # marks the session FAILED, journal kept

    return {s["spec"].session_id: out[s["spec"].session_id]
            for s in sessions}


@dataclass
class Campaign:
    """An ordered set of session specs run as one unit."""

    specs: list[SessionSpec] = field(default_factory=list)

    @staticmethod
    def grid(problems: Sequence[str], tuners: Sequence[str],
             archs: Sequence[str] = (DEFAULT_ARCH,),
             seeds: Iterable[int] = (0,),
             budget: int = 100, workers: int = 4,
             tuner_kwargs: dict | None = None,
             problem_kwargs: dict | None = None) -> "Campaign":
        """The full cross product, in deterministic order.

        Per-tuner campaign defaults from
        :data:`~repro_torch.orchestrator.session.CAMPAIGN_TUNER_DEFAULTS` (e.g.
        SurrogateBO's ``batch_width=8``) are applied beneath explicit
        ``tuner_kwargs``, per session — they are part of the spec (and its
        ``session_id``), so a grid's trajectories are fixed at build time.
        ``problem_kwargs`` (e.g. ``{"device": "cpu"}``) goes to every spec.
        """
        specs = [
            SessionSpec(problem=p, tuner=t, arch=a, budget=budget, seed=s,
                        workers=workers,
                        tuner_kwargs={**CAMPAIGN_TUNER_DEFAULTS.get(t, {}),
                                      **(tuner_kwargs or {})},
                        problem_kwargs=dict(problem_kwargs or {}))
            for p in problems for t in tuners for a in archs for s in seeds
        ]
        return Campaign(specs)

    def __len__(self) -> int:
        return len(self.specs)

    # -- execution --------------------------------------------------------- #
    def run(self, store: SessionStore | None = None, *,
            workers: int | None = None, mode: str = "auto",
            max_retries: int = 2, interleave: bool = False,
            share_archs: bool = True, problems: dict | None = None,
            broker: Broker | None = None,
            on_session: Callable[[SessionSpec, TuneResult], None] | None = None
            ) -> dict[str, TuneResult]:
        """Run every session; returns {session_id: trace}.

        ``interleave=True`` multiplexes all sessions over one shared worker
        pool (see :func:`run_campaign`) — same trajectories and journals,
        one warm executor, arch-shared evaluation for portability grids.
        ``broker=`` hands evaluation to a durable job queue served by
        detached worker processes (implies interleaving, with async tell).
        Sessions already marked done in the store are re-run as pure journal
        replays (no hardware evaluations), which is cheap and keeps the
        return value complete.
        """
        if interleave or broker is not None:
            return run_campaign(self.specs, store,
                                workers=4 if workers is None else workers,
                                mode=mode, max_retries=max_retries,
                                share_archs=share_archs, problems=problems,
                                broker=broker, on_session=on_session)
        out: dict[str, TuneResult] = {}
        for spec in self.specs:
            res = run_session(spec, store=store, workers=workers, mode=mode,
                              max_retries=max_retries)
            out[spec.session_id] = res
            if on_session is not None:
                on_session(spec, res)
        return out

    # -- reporting --------------------------------------------------------- #
    def status(self, store: SessionStore) -> list[dict]:
        """One row per session: id, state, progress, best objective."""
        rows = []
        for spec in self.specs:
            sid = spec.session_id
            if store.exists(sid):
                m = store.meta(sid)
                rows.append({"session": sid, "status": m["status"],
                             "evaluated": m.get("evaluated", 0),
                             "budget": spec.budget, "best": m.get("best")})
            else:
                rows.append({"session": sid, "status": "not-submitted",
                             "evaluated": 0, "budget": spec.budget,
                             "best": None})
        return rows

    def done(self, store: SessionStore) -> bool:
        return all(r["status"] == DONE for r in self.status(store))
