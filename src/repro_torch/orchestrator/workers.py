"""Worker pool: parallel config evaluation with fault isolation.

Two execution modes, chosen per call from the problem and the arch id:

* ``thread`` — for the cost model and plain function problems.  Chunks of
  the batch go through ``TunableProblem.evaluate_many`` (the vectorized
  fast path), one chunk per worker thread, in this process.
* ``process`` — for a :class:`MeasuredProblem` under the arch it measures
  (its device's id), where a worker can take down its interpreter (a
  crashing kernel, a broken CUDA context) and measurements must not
  contend on the GIL.  Workers are *spawned*, never forked: a child forked
  after the parent touched CUDA cannot use the card.  One measuring
  process per device: on the card the pool runs at most
  ``torch.cuda.device_count()`` processes, each pinned to its own device
  index when it starts (one process, on that card, where the problem's
  device names an index), and a larger ``workers`` is clamped (the clamp
  is printed); on the host, one.  Two processes timing configs on one device
  at once would corrupt both medians.  The problem crosses to the child by
  pickling: a kernel problem pickles as its constructor's arguments and is
  rebuilt, once per process, on the child's device
  (``kernels.common.KernelProblem.__reduce__``).

The same problem may take both modes in one pool: a portability campaign
asks the device's arch (measured, in the processes) and the cost model's
(host arithmetic, in threads) of one problem.  ``mode=`` fixes one mode
for every call instead.

Fault handling: a chunk that raises is retried config-by-config through a
:class:`JobQueue`; a config that keeps raising past the retry cap is
*poisoned* — returned as an invalid :class:`Trial` carrying the error, so
one bad config can never wedge a session.  A config that breaks its
worker's CUDA context (a device-side assert, an illegal address) would
fail every later config in that process; the worker exits instead, so the
pool is rebuilt as on any worker death and only that config ends
poisoned.  Each measured trial's ``info`` records the device index it ran
on (``"device"``), and the children's spans (``kernel.build``,
``kernel.measure``) come back to the parent's trace, tagged with the
child's ``pid``.

Shared pools: every evaluation entry point takes per-call ``problem=`` and
``arch=`` overrides, so one pool (one executor, one set of warm workers)
can serve every session of a campaign grid regardless of which problem or
architecture each session tunes.  The arch-shared form
``evaluate_rows(rows, archs=[...])`` evaluates each row ONCE via
``TunableProblem.trials_for_rows_archs`` (one decode + one set of value
columns shared by all architectures) and returns per-arch trial lists —
the portability-campaign fast path, for the cost model's ids; a measured
arch is refused there, since the campaign's partition gives it a batch of
its own.
"""

from __future__ import annotations

import json
import math
import multiprocessing
import os
import sys
import threading
import time
from concurrent.futures import (FIRST_COMPLETED, BrokenExecutor, Executor,
                                ProcessPoolExecutor, ThreadPoolExecutor, wait)
from typing import Sequence

from ..core.problem import MeasuredProblem, Trial, TunableProblem
from ..core.space import Config
from ..telemetry import trace
from ..telemetry.trace import span
from . import chaos
from .queue import DONE, JobQueue


class EvalCancelled(Exception):
    """An in-flight batch was abandoned on purpose (lease lost): the
    worker's result would be rejected by completion-requires-lease, so
    finishing the evaluation is pure waste.  Raised out of the pool's
    wait loops when the caller's cancel event is set."""


#: thread-mode minimum chunk size: splitting a small analytical batch
#: across every worker forfeits the columnar evaluation path for pure
#: scheduler overhead.  Results are chunking-independent (the
#: compiled-path equivalence property), so this is a wall-clock knob only.
_THREAD_CHUNK_FLOOR = 32

#: exit code of a measuring worker whose CUDA context a config broke
CONTEXT_LOST_EXIT = 75


def measures(problem: TunableProblem, arch: str | None) -> bool:
    """Whether ``problem`` answers ``arch`` by timing configs on a device
    (else by the cost model or a plain function, host arithmetic)."""
    return isinstance(problem, MeasuredProblem) and \
        not problem.analytical(arch)


def measuring_cards(problem: MeasuredProblem) -> list[int]:
    """The CUDA device indices ``problem``'s measuring processes are pinned
    to: the one its device names (``cuda:1``), else every visible card;
    none on the host."""
    if problem.device.type != "cuda":
        return []
    if problem.device.index is not None:
        return [problem.device.index]
    import torch
    return list(range(torch.cuda.device_count()))


def measuring_devices(problem: MeasuredProblem) -> int:
    """How many devices ``problem`` can measure on at once: its cards
    (:func:`measuring_cards`), one for the host."""
    return max(1, len(measuring_cards(problem)))


def _evaluate_chunk(problem: TunableProblem, configs: list[Config],
                    arch: str) -> list[Trial]:
    # module-level so the process pool can pickle it.  Chunk spans record
    # in the executing thread's (or, for process mode, the child's own)
    # ring buffer — per-chunk, never per-config.  chaos site eval.hang
    # simulates a wedged measurement *inside* the chunk — it pins this
    # executor thread exactly like a hung kernel build would.
    chaos.sleep(chaos.EVAL_HANG)
    with span("pool.chunk", cat="pool", n=len(configs), arch=arch):
        return problem.evaluate_many(configs, arch)


def _evaluate_rows_chunk(problem: TunableProblem, rows: list[int],
                         arch: str) -> list[Trial]:
    chaos.sleep(chaos.EVAL_HANG)
    with span("pool.chunk", cat="pool", n=len(rows), arch=arch):
        return problem.trials_for_rows(rows, arch)


def _evaluate_rows_archs_chunk(problem: TunableProblem, rows: list[int],
                               archs: tuple[str, ...]) -> list[list[Trial]]:
    chaos.sleep(chaos.EVAL_HANG)
    with span("pool.chunk", cat="pool", n=len(rows), archs=len(archs)):
        return problem.trials_for_rows_archs(rows, archs)


def _evaluate_one(problem: TunableProblem, config: Config, arch: str) -> Trial:
    chaos.sleep(chaos.EVAL_HANG)
    return problem.evaluate(config, arch)


# --------------------------------------------------------------------- #
# the spawned worker process
# --------------------------------------------------------------------- #
#: the CUDA device index this worker process measures on (None: the host,
#: or a worker of a problem that does not measure)
_DEVICE: int | None = None


class _FromChild:
    """A child's result plus the spans it recorded producing it."""

    __slots__ = ("value", "spans", "pid")

    def __init__(self, value, spans: list, pid: int):
        self.value = value
        self.spans = spans
        self.pid = pid


def _init_worker(slots, cards: list[int] | None, tracing: bool) -> None:
    """Process-pool initializer: take the next slot and, with ``cards``
    (device indices; ``None``: every card visible here), pin this process
    to ``cards[slot mod len(cards)]`` before anything touches CUDA; record
    spans when the parent does."""
    global _DEVICE
    with slots.get_lock():
        slot = slots.value
        slots.value += 1
    if cards is None:
        import torch
        cards = list(range(torch.cuda.device_count()))
    if cards:
        import torch
        _DEVICE = cards[slot % len(cards)]
        torch.cuda.set_device(_DEVICE)
    if tracing:
        trace.enable()


def _context_usable() -> bool:
    """Whether this process's CUDA context still runs work: a device-side
    assert or an illegal address leaves it failing every later call."""
    import torch
    try:
        torch.cuda.synchronize()
        torch.ones(1, device="cuda").add_(1).item()
        return True
    except Exception:
        return False


def _measure_one(problem: TunableProblem, config: Config,
                 arch: str) -> Trial:
    t = problem.evaluate(config, arch)
    if _DEVICE is None:
        return t
    if not t.valid and "error" in t.info and not _context_usable():
        # every later config here would fail too: die, so the pool is
        # rebuilt and only this config is retried toward its poison
        os._exit(CONTEXT_LOST_EXIT)
    if t.valid:
        t.info["device"] = _DEVICE
    return t


def _launch_counts() -> dict[str, int]:
    """The port's kernel launch counts in this process, where a kernel
    problem has brought in its ops (nothing is imported for a toy)."""
    kernels = sys.modules.get("repro_torch.kernels")
    return {} if kernels is None else kernels.launch_counts()


def _launched(sp, before: dict[str, int]) -> None:
    """Record on span ``sp`` the kernels launched since ``before``."""
    after = _launch_counts()
    sp.set(launches={k: n - before.get(k, 0) for k, n in after.items()
                     if n != before.get(k, 0)})


def _child_chunk(problem: TunableProblem, configs: list[Config],
                 arch: str) -> _FromChild:
    chaos.sleep(chaos.EVAL_HANG)
    with span("pool.chunk", cat="pool", n=len(configs), arch=arch) as sp:
        before = _launch_counts() if sp.enabled else {}
        if _DEVICE is None:
            trials = problem.evaluate_many(configs, arch)
        else:
            trials = [_measure_one(problem, c, arch) for c in configs]
        if sp.enabled:
            _launched(sp, before)
    return _FromChild(trials, trace.drain(), os.getpid())


def _child_one(problem: TunableProblem, config: Config,
               arch: str) -> _FromChild:
    chaos.sleep(chaos.EVAL_HANG)
    with span("pool.retry", cat="pool", arch=arch) as sp:
        before = _launch_counts() if sp.enabled else {}
        t = _measure_one(problem, config, arch)
        if sp.enabled:
            _launched(sp, before)
    return _FromChild(t, trace.drain(), os.getpid())


def _landed(result):
    """A future's value; a child's spans join this process's trace."""
    if isinstance(result, _FromChild):
        if result.spans:
            trace.ingest(result.spans, pid=result.pid)
        return result.value
    return result


#: a measuring process started before this process built its problem
#: (:func:`start_early`): (executor, the card it pins, whether it traces)
_EARLY: tuple[ProcessPoolExecutor, int | None, bool] | None = None


def start_early(card: int | None, tracing: bool) -> None:
    """Spawn one measuring process now, pinned to ``card`` (``None``: the
    first visible card, where a pool of one process on a card pins it), so
    that its start (interpreter, ``import torch``, the CUDA context) runs
    while this process imports torch to build its problem, not after.  The
    first :class:`WorkerPool` whose measuring executor is one process on
    that card, tracing as ``tracing`` says, adopts it; any other shuts it
    down.  What the process measures is unchanged: the same pinning, the
    same problem pickled to it with its first job."""
    global _EARLY
    ctx = multiprocessing.get_context("spawn")
    ex = ProcessPoolExecutor(
        max_workers=1, mp_context=ctx, initializer=_init_worker,
        initargs=(ctx.Value("i", 0), None if card is None else [card],
                  tracing))
    ex.submit(int)            # a pool spawns its process with its first job
    _EARLY = (ex, card, tracing)


def _adopt_early(n: int, cards: list[int],
                 tracing: bool) -> ProcessPoolExecutor | None:
    """The early process's executor, if it is the one a pool of ``n``
    processes pinned to ``cards`` would build; else ``None``, and the early
    process is shut down."""
    global _EARLY
    if _EARLY is None:
        return None
    ex, card, early_tracing = _EARLY
    _EARLY = None
    if (n == 1 and cards and cards[0] == (0 if card is None else card)
            and tracing == early_tracing):
        print("worker pool: adopted the measuring process started before "
              "the problem was built", file=sys.stderr, flush=True)
        return ex
    ex.shutdown(wait=False, cancel_futures=True)
    return None


class WorkerPool:
    """Evaluates batches of configs for one problem on one arch (both
    overridable per call for shared campaign pools).

    Results always come back in input order regardless of completion order —
    the property the session runner relies on for determinism.
    """

    def __init__(self, problem: TunableProblem, arch: str, workers: int = 4,
                 mode: str = "auto", max_retries: int = 2,
                 job_timeout_s: float | None = None):
        if mode not in ("auto", "thread", "process"):
            raise ValueError(f"unknown worker mode {mode!r}")
        self.problem = problem
        self.arch = arch
        self.workers = max(1, int(workers))
        self._fixed_mode = None if mode == "auto" else mode
        #: the mode of the pool's own (problem, arch); calls that override
        #: either resolve their own
        self.mode = self._mode_for(problem, arch)
        self.max_retries = max_retries
        # the evaluation watchdog: bounds the chunked fast path as one
        # batch deadline, then each per-config retry attempt separately —
        # a config whose *every* attempt exceeds it terminates as a
        # timeout-poison trial (info: poison + timeout) instead of
        # pinning the pool until the broker reaps the lease
        self.job_timeout_s = job_timeout_s
        #: watchdog observability: bumped on every timed-out chunk/attempt
        #: and every cancelled batch (read by BrokerWorker job metrics)
        self.stats = {"timeouts": 0, "cancelled": 0}
        self._exs: dict[str, Executor] = {}
        self._sizes: dict[str, int] = {}
        #: modes whose executor lost a process since it was built
        self._broken: set[str] = set()

    def _mode_for(self, problem: TunableProblem, arch: str | None) -> str:
        if self._fixed_mode is not None:
            return self._fixed_mode
        return "process" if measures(problem, arch) else "thread"

    def _size(self, mode: str, problem: TunableProblem,
              arch: str | None) -> int:
        """The executor's width: ``workers``, clamped to one per device
        where the calls measure."""
        if not measures(problem, arch):
            return self.workers
        n = min(self.workers, measuring_devices(problem))
        if n < self.workers:
            print(f"worker pool: {self.workers} workers asked, {n} "
                  f"measuring {mode}(es) on {problem.device.type} "
                  f"(one per device)", file=sys.stderr, flush=True)
        return n

    # -- lifecycle -------------------------------------------------------- #
    def _executor(self, mode: str, problem: TunableProblem | None = None,
                  arch: str | None = None) -> Executor:
        if mode in self._broken:
            return self._rebuild(mode, problem, arch)
        if mode not in self._exs:
            problem = problem or self.problem
            n = self._sizes.get(mode)
            if n is None:
                n = self._sizes[mode] = self._size(mode, problem,
                                                   arch or self.arch)
            if mode == "thread":
                self._exs[mode] = ThreadPoolExecutor(max_workers=n)
            else:
                cards = (measuring_cards(problem)
                         if measures(problem, arch or self.arch) else [])
                ex = _adopt_early(n, cards, trace.is_enabled())
                if ex is None:
                    ctx = multiprocessing.get_context("spawn")
                    ex = ProcessPoolExecutor(
                        max_workers=n, mp_context=ctx,
                        initializer=_init_worker,
                        initargs=(ctx.Value("i", 0), cards,
                                  trace.is_enabled()))
                self._exs[mode] = ex
        return self._exs[mode]

    def _rebuild(self, mode: str, problem: TunableProblem | None = None,
                 arch: str | None = None) -> Executor:
        """Replace a broken executor (a worker OOM/segfault kills the whole
        ProcessPoolExecutor, not just its job)."""
        self._broken.discard(mode)
        ex = self._exs.pop(mode, None)
        if ex is not None:
            ex.shutdown(wait=False)
        return self._executor(mode, problem, arch)

    def close(self) -> None:
        for ex in self._exs.values():
            ex.shutdown(wait=True)
        self._exs.clear()

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- evaluation ------------------------------------------------------- #
    def evaluate_rows(self, rows: Sequence[int], arch: str | None = None,
                      *, archs: Sequence[str] | None = None,
                      problem: TunableProblem | None = None,
                      cancel: threading.Event | None = None):
        """Row-native :meth:`evaluate`: valid compiled-space rows in, trials
        out — same ordering/fault-isolation guarantees, but the chunks run
        ``TunableProblem.trials_for_rows`` (value columns straight from the
        code matrix, no per-config dict work; configs stay lazy).

        With ``archs=`` the call becomes arch-shared: each row is evaluated
        exactly once — one decode, one set of value columns, one feature
        build when ``arch_independent_features`` — and the return value is
        ``{arch: list[Trial]}`` with every list aligned with ``rows``.
        Bit-identical to one single-arch call per architecture (the
        compiled-path equivalence property), at ~1/len(archs) the work.
        """
        problem = problem or self.problem
        if archs is not None:
            return self._evaluate_rows_archs(rows, tuple(archs), problem,
                                             cancel=cancel)
        rows = [int(r) for r in rows]
        if not rows:
            return []
        arch = arch or self.arch
        if self._mode_for(problem, arch) == "process":
            # measured problems re-derive everything from configs anyway;
            # keep one battle-tested path through the process pool
            cfgs = self._rows_to_configs(rows, problem)
            return self.evaluate(cfgs, arch, problem=problem, cancel=cancel)
        return self._evaluate_chunked(rows, arch, _evaluate_rows_chunk,
                                      self._rows_to_configs, problem,
                                      cancel=cancel)

    def _rows_to_configs(self, rows: list[int],
                         problem: TunableProblem | None = None) -> list[Config]:
        problem = problem or self.problem
        comp = problem.space.compiled()
        if comp is not None:
            return comp.decode_many(rows)
        return [problem.space.from_flat_index(int(r)) for r in rows]

    def evaluate(self, configs: Sequence[Config], arch: str | None = None,
                 *, problem: TunableProblem | None = None,
                 cancel: threading.Event | None = None) -> list[Trial]:
        """Evaluate ``configs`` in parallel; ordered, fault-isolated."""
        configs = list(configs)
        if not configs:
            return []
        return self._evaluate_chunked(configs, arch or self.arch,
                                      _evaluate_chunk, None,
                                      problem or self.problem, cancel=cancel)

    # -- arch-shared evaluation ------------------------------------------- #
    def _evaluate_rows_archs(self, rows: Sequence[int], archs: tuple[str, ...],
                             problem: TunableProblem,
                             cancel: threading.Event | None = None
                             ) -> dict[str, list[Trial]]:
        rows = [int(r) for r in rows]
        if not rows:
            return {a: [] for a in archs}
        if any(measures(problem, a) for a in archs):
            # a measurement belongs to one device: the campaign's partition
            # (campaign._partition_archsets) gives a measured arch a batch
            # of its own, and the cost model's endpoints refuse its id
            raise ValueError(
                f"arch-shared evaluation over {list(archs)}: a measured arch "
                f"takes a single-arch batch (evaluate_rows(rows, arch=...))")

        mode = self._mode_for(problem, archs[0])
        ex = self._executor(mode, problem, archs[0])
        deadline = (None if self.job_timeout_s is None
                    else time.monotonic() + self.job_timeout_s)
        with span("pool.evaluate", cat="pool", n=len(rows),
                  archs=len(archs), mode=mode):
            done, retry, broken = self._run_chunks(
                rows, mode, lambda chunk: ex.submit(
                    _evaluate_rows_archs_chunk, problem, chunk, archs),
                cancel=cancel, deadline=deadline)
        out: dict[str, list] = {a: [None] * len(rows) for a in archs}
        for lo, hi, per_arch in done:
            for a, trials in zip(archs, per_arch):
                out[a][lo:hi] = trials

        if retry:
            # per-row isolation: decode just the failing rows once, then run
            # the per-config retry/poison machinery independently per arch
            # (a row can be poisoned on one architecture and fine on another)
            decoded = self._rows_to_configs([rows[i] for i in retry], problem)
            configs: list = list(rows)
            for i, cfg in zip(retry, decoded):
                configs[i] = cfg
            if broken:
                ex = self._rebuild(mode, problem, archs[0])
            for a in archs:
                self._evaluate_with_retries(
                    configs, retry, out[a], a, ex, mode, problem,
                    cancel=cancel, attempt_timeout_s=self.job_timeout_s)
        return out

    def _n_chunks(self, mode: str, n_items: int) -> int:
        if mode == "thread":
            return max(1, min(self._sizes.get(mode, self.workers),
                              n_items // _THREAD_CHUNK_FLOOR))
        return min(self._sizes.get(mode, self.workers), n_items)

    def _run_chunks(self, items: list, mode: str, submit, *,
                    cancel: threading.Event | None = None,
                    deadline: float | None = None
                    ) -> tuple[list, list[int], bool]:
        """Fan ``items`` out as worker chunks (``submit(chunk) -> Future``).

        Returns ``(done, retry, broken)``: ``done`` as ``(lo, hi, result)``
        per successful chunk, ``retry`` the item indices of chunks that
        raised (poison isolation runs them one by one), and ``broken`` True
        when the executor must be rebuilt before retrying — after a
        BrokenExecutor, at submit (a pool that broke at the end of the
        previous batch) or at completion, or after the watchdog fired (the
        hung chunk's thread still occupies the old executor).

        ``deadline`` (monotonic) is the batch watchdog: chunks still
        pending then are cancelled and routed to the per-config retry
        path, where each config gets its own attempt timeout.
        ``cancel`` abandons the whole batch by raising
        :class:`EvalCancelled` — the lease-lost fast exit.
        """
        n_chunks = self._n_chunks(mode, len(items))
        bounds = [round(i * len(items) / n_chunks)
                  for i in range(n_chunks + 1)]
        spans = [(bounds[i], bounds[i + 1]) for i in range(n_chunks)
                 if bounds[i] < bounds[i + 1]]
        pending: dict = {}
        done: list = []
        retry: list[int] = []
        broken = False
        for lo, hi in spans:
            if broken:                     # no use submitting to it again
                retry.extend(range(lo, hi))
                continue
            try:
                pending[submit(items[lo:hi])] = (lo, hi)
            except BrokenExecutor:
                retry.extend(range(lo, hi))
                broken = True
        block = cancel is None and deadline is None
        while pending:
            if cancel is not None and cancel.is_set():
                for fut in pending:
                    fut.cancel()
                self.stats["cancelled"] += 1
                raise EvalCancelled("batch abandoned (lease lost)")
            finished, _ = wait(list(pending),
                               timeout=None if block else 0.05,
                               return_when=FIRST_COMPLETED)
            for fut in finished:
                lo, hi = pending.pop(fut)
                try:
                    done.append((lo, hi, _landed(fut.result())))
                except BrokenExecutor:
                    retry.extend(range(lo, hi))
                    broken = True
                except Exception:
                    retry.extend(range(lo, hi))  # isolate the poison item(s)
            if deadline is not None and pending \
                    and time.monotonic() >= deadline:
                for fut, (lo, hi) in pending.items():
                    fut.cancel()
                    retry.extend(range(lo, hi))
                pending.clear()
                self.stats["timeouts"] += 1
                broken = True
        return done, retry, broken

    def _evaluate_chunked(self, items: list, arch: str, chunk_fn,
                          to_configs, problem: TunableProblem,
                          cancel: threading.Event | None = None
                          ) -> list[Trial]:
        mode = self._mode_for(problem, arch)
        if mode == "process":
            chunk_fn = _child_chunk         # configs: see evaluate_rows
        ex = self._executor(mode, problem, arch)
        deadline = (None if self.job_timeout_s is None
                    else time.monotonic() + self.job_timeout_s)

        # 1. chunked fast path: one evaluate_many per worker
        with span("pool.evaluate", cat="pool", n=len(items), arch=arch,
                  mode=mode):
            done, retry, broken = self._run_chunks(
                items, mode, lambda chunk: ex.submit(chunk_fn, problem,
                                                     chunk, arch),
                cancel=cancel, deadline=deadline)
        out: list[Trial | None] = [None] * len(items)
        for lo, hi, trials in done:
            out[lo:hi] = trials

        # 2. per-config retry path through the job queue
        if retry:
            configs = items
            if to_configs is not None:       # rows: decode just the retries
                decoded = to_configs([items[i] for i in retry], problem)
                configs = list(items)
                for i, cfg in zip(retry, decoded):
                    configs[i] = cfg
            if broken:
                ex = self._rebuild(mode, problem, arch)
            self._evaluate_with_retries(configs, retry, out, arch, ex, mode,
                                        problem, cancel=cancel,
                                        attempt_timeout_s=self.job_timeout_s)
        return out  # type: ignore[return-value]

    def _evaluate_with_retries(self, configs: list[Config], indices: list[int],
                               out: list, arch: str, ex: Executor, mode: str,
                               problem: TunableProblem | None = None, *,
                               cancel: threading.Event | None = None,
                               attempt_timeout_s: float | None = None) -> None:
        problem = problem or self.problem
        one = _child_one if mode == "process" else _evaluate_one
        # a process that dies fails every attempt queued in it, and a
        # process pool that loses one process fails every attempt in
        # flight.  So one attempt runs per process, and a death that hit
        # several attempts charges none of them: they rerun one at a time,
        # where a death is the attempt's own (on one card, the config that
        # broke the context is the only one charged)
        cap = self._sizes[mode] if mode == "process" else math.inf
        queue = JobQueue(self.max_retries)
        for i in indices:
            queue.submit(i, configs[i])       # key == batch index: unique

        running: dict = {}
        deadlines: dict = {}
        alone: dict = {}                      # future -> ran by itself
        owner: dict = {}                      # future -> its executor

        def launch() -> None:
            nonlocal ex
            while len(running) < cap:
                job = queue.take()
                if job is None:
                    return
                if mode in self._broken:
                    ex = self._rebuild(mode, problem, arch)
                try:
                    fut = ex.submit(one, problem, job.config, arch)
                except BrokenExecutor:
                    ex = self._rebuild(mode, problem, arch)
                    fut = ex.submit(one, problem, job.config, arch)
                running[fut] = job
                alone[fut] = cap == 1
                owner[fut] = ex
                if attempt_timeout_s is not None:
                    deadlines[fut] = time.monotonic() + attempt_timeout_s

        launch()
        block = cancel is None and attempt_timeout_s is None
        while running:
            if cancel is not None and cancel.is_set():
                for fut in running:
                    fut.cancel()
                self.stats["cancelled"] += 1
                raise EvalCancelled("batch abandoned (lease lost)")
            done, _ = wait(list(running), timeout=None if block else 0.05,
                           return_when=FIRST_COMPLETED)
            for fut in done:
                job = running.pop(fut)
                deadlines.pop(fut, None)
                err = fut.exception()
                if isinstance(err, BrokenExecutor) \
                        and owner[fut] is self._exs.get(mode):
                    self._broken.add(mode)    # rebuilt at the next submit
                if err is None:
                    queue.complete(job, _landed(fut.result()))
                elif isinstance(err, BrokenExecutor) and not alone[fut]:
                    # the death may be another attempt's: rerun, uncharged,
                    # one attempt at a time on the rebuilt pool
                    cap = 1
                    queue.requeue(job, repr(err))
                else:
                    # a config that kills its worker every time still
                    # terminates as poisoned
                    job.timed_out = False
                    queue.fail(job, repr(err))   # requeue or poison
            if attempt_timeout_s is not None and running:
                now = time.monotonic()
                hung = [f for f, dl in deadlines.items()
                        if f in running and dl <= now]
                for fut in hung:
                    job = running.pop(fut)
                    deadlines.pop(fut, None)
                    fut.cancel()
                    # each retry gets a fresh attempt budget; a config
                    # whose every attempt times out poisons with the
                    # timeout marker (see the tail loop below)
                    job.timed_out = True
                    self.stats["timeouts"] += 1
                    queue.fail(job, "evaluation timed out after "
                                    f"{attempt_timeout_s:g}s")
                if hung:
                    # the hung attempts' threads still occupy the old
                    # executor — retries need fresh workers
                    ex = self._rebuild(mode, problem, arch)
            launch()

        for i in indices:
            job = queue.job(i)
            if job is not None and job.state == DONE:
                out[i] = job.result
            else:
                info = {"error": job.error if job else "lost",
                        "poison": True,
                        "attempts": job.attempts if job else 0}
                if job is not None and job.timed_out:
                    info["timeout"] = True
                out[i] = Trial(configs[i], math.inf, arch, valid=False,
                               info=info)


# --------------------------------------------------------------------- #
# broker workers: the detached fleet behind a durable job queue
# --------------------------------------------------------------------- #
class BrokerWorker:
    """One worker loop serving a :class:`~repro_torch.orchestrator.broker.Broker`.

    The fleet member behind ``python -m repro_torch.orchestrator worker``:
    leases one job at a time, keeps the lease alive from a heartbeat
    thread while the evaluation runs, and publishes the result —
    ``complete`` on success, ``fail`` (requeue, attempts-capped) on an
    infrastructure error.  *Evaluation* faults never fail the job: the
    batch runs through this worker's own :class:`WorkerPool`, whose
    per-config retry/poison machinery turns a raising config into an
    invalid trial exactly as in-process evaluation would — so broker
    results are bit-identical to pool results, poison markers included.

    Problems are materialized from the registry by name (the job payload
    carries ``problem``/``pk``) and cached, one live problem + one warm
    pool per problem for the life of the worker: a campaign's stream of
    jobs pays the space compile once, like the in-process scheduler.
    """

    def __init__(self, broker, *, worker_id: str | None = None,
                 workers: int = 2, mode: str = "auto", max_retries: int = 2,
                 lease_s: float = 30.0, poll_s: float = 0.05,
                 job_timeout_s: float | None = None, log=None,
                 clock=time.monotonic):
        from .broker import default_worker_id
        self.broker = broker
        self.worker_id = worker_id or default_worker_id()
        # idle-age bookkeeping measures *durations*, so the monotonic
        # clock is correct (wall-time steps must not retire a worker);
        # injectable so tests drive --max-idle without real sleeping
        self._clock = clock
        self.workers = workers
        self.mode = mode
        self.max_retries = max_retries
        self.lease_s = lease_s
        self.poll_s = poll_s
        self.job_timeout_s = job_timeout_s
        self.log = log or (lambda msg: None)
        self._problems: dict[str, TunableProblem] = {}
        self._pools: dict[str, WorkerPool] = {}

    # -- problem/pool cache ------------------------------------------------ #
    def _problem(self, payload: dict) -> tuple[TunableProblem, WorkerPool]:
        from .registry import make_problem
        key = json.dumps([payload["problem"], payload.get("pk", {})],
                         sort_keys=True)
        if key not in self._problems:
            problem = make_problem(payload["problem"], **payload.get("pk", {}))
            problem.space.compile_eagerly()
            self._problems[key] = problem
            self._pools[key] = WorkerPool(
                problem, payload["archs"][0], workers=self.workers,
                mode=self.mode, max_retries=self.max_retries,
                job_timeout_s=self.job_timeout_s)
        return self._problems[key], self._pools[key]

    # -- evaluation -------------------------------------------------------- #
    def _evaluate(self, payload: dict,
                  cancel: threading.Event | None = None) -> dict:
        from .broker import encode_trial
        problem, pool = self._problem(payload)
        archs = list(payload["archs"])
        if payload.get("rows") is not None:
            rows = [int(r) for r in payload["rows"]]
            if len(archs) > 1:
                per_arch = pool.evaluate_rows(rows, archs=archs,
                                              problem=problem, cancel=cancel)
            else:
                per_arch = {archs[0]: pool.evaluate_rows(
                    rows, arch=archs[0], problem=problem, cancel=cancel)}
        else:
            cfgs = [problem.space.decode(c) for c in payload["configs"]]
            per_arch = {a: pool.evaluate(cfgs, a, problem=problem,
                                         cancel=cancel)
                        for a in archs}
        return {"arch_trials": {a: [encode_trial(t) for t in trials]
                                for a, trials in per_arch.items()}}

    def _pool_stat(self, name: str) -> int:
        return sum(p.stats.get(name, 0) for p in self._pools.values())

    # -- the loop ---------------------------------------------------------- #
    def _heartbeat_loop(self, job_id: int, stop: threading.Event,
                        cancel: threading.Event) -> None:
        # its own broker connection (SQLite connections are thread-local);
        # a False heartbeat means the lease was reaped — this worker was
        # presumed dead and the job re-leased, so stop renewing AND set
        # ``cancel``: our eventual complete/fail would be rejected
        # (concurrent-worker dedup), so finishing the doomed batch is
        # pure waste — the pool abandons it at the next chunk boundary
        interval = max(self.lease_s / 3.0, 0.01)
        while not stop.wait(interval):
            stall = chaos.fire(chaos.WORKER_HEARTBEAT_STALL)
            if stall is not None:
                # injected GC pause / network partition: no renewals for
                # stall_s — past the lease, the broker reaps us
                if stop.wait(float(stall.get("stall_s", self.lease_s))):
                    return
            with span("broker.heartbeat", cat="broker", job=job_id):
                alive = self.broker.heartbeat(job_id, self.worker_id,
                                              self.lease_s)
            if not alive:
                cancel.set()
                return

    def _record_job_metrics(self, result: dict, seconds: float,
                            timeouts: int = 0) -> None:
        """Durable per-job throughput samples into the broker's metrics
        stream.  Always recorded (not gated by the in-process telemetry
        flag): one insert per *job* — a whole evaluation batch — so the
        cost is noise, and the fleet view works without every worker
        opting in.  Recorded before ``complete``, so the samples survive
        even when the lease was lost and the result is rejected — the
        work happened either way."""
        trials = result["arch_trials"]
        evals = sum(len(ts) for ts in trials.values())
        poison = sum(1 for ts in trials.values()
                     for _, _, info in ts if info.get("poison"))
        samples = [
            {"name": "jobs", "value": 1, "kind": "counter"},
            {"name": "evals", "value": evals, "kind": "counter"},
            {"name": "eval_s", "value": seconds, "kind": "counter"},
            {"name": "poison", "value": poison, "kind": "counter"},
            {"name": "configs_per_s", "kind": "gauge",
             "value": evals / seconds if seconds > 0 else 0.0},
        ]
        if timeouts:
            samples.append({"name": "timeouts", "value": timeouts,
                            "kind": "counter"})
        if chaos.active():
            # observed fault schedule, cumulative per worker process:
            # gauges (last-write-wins per worker id) sum across a fleet
            # to the total injected-fault count the bench publishes
            samples.extend({"name": f"chaos.{site}", "kind": "gauge",
                            "value": st["fires"]}
                           for site, st in chaos.stats().items()
                           if st["fires"])
        try:
            self.broker.record_metrics(self.worker_id, samples)
        except Exception as e:    # telemetry must never take down a worker
            self.log(f"job metrics record failed: {e!r}")

    def serve_one(self, job_id: int, payload: dict) -> bool:
        """Evaluate one leased job; returns True if the result landed."""
        stop = threading.Event()
        cancel = threading.Event()
        hb = threading.Thread(target=self._heartbeat_loop,
                              args=(job_id, stop, cancel), daemon=True)
        hb.start()
        t0 = time.monotonic()
        timeouts0 = self._pool_stat("timeouts")
        try:
            with span("worker.job", cat="worker", job=job_id):
                result = self._evaluate(payload, cancel=cancel)
        except EvalCancelled:
            # the heartbeat thread observed a reaped lease: the job was
            # already re-leased elsewhere and our result would be
            # rejected — don't complete, don't fail (that would race the
            # new holder), just record the abandonment and lease again
            try:
                self.broker.record_metrics(self.worker_id, [
                    {"name": "abandoned", "value": 1, "kind": "counter"}])
            except Exception:
                pass
            self.log(f"job {job_id} abandoned (lease lost mid-batch)")
            return False
        except Exception as e:
            # evaluation infrastructure error: requeue the job (attempts-
            # capped).  KeyboardInterrupt/SystemExit propagate instead —
            # the worker dies and the lease expires, which is the same
            # requeue without burning an attempt on an operator Ctrl-C.
            with span("broker.fail", cat="broker", job=job_id):
                self.broker.fail(job_id, self.worker_id, repr(e))
            self.log(f"job {job_id} failed: {e!r}")
            return False
        finally:
            stop.set()
            hb.join()
        chaos.crash(chaos.WORKER_CRASH_BEFORE_COMPLETE)
        self._record_job_metrics(result, time.monotonic() - t0,
                                 timeouts=self._pool_stat("timeouts")
                                 - timeouts0)
        with span("broker.complete", cat="broker", job=job_id):
            ok = self.broker.complete(job_id, self.worker_id, result)
        self.log(f"job {job_id} {'done' if ok else 'lost lease'}")
        return ok

    def run(self, *, max_jobs: int | None = None,
            max_idle_s: float | None = None,
            stop: threading.Event | None = None) -> int:
        """Serve jobs until stopped; returns how many were served.

        ``max_idle_s`` bounds how long the worker polls an empty queue
        before exiting (fleet teardown without a control channel);
        ``max_jobs`` and ``stop`` exist for tests and manual drains.
        """
        served = 0
        idle_since = self._clock()
        while True:
            if stop is not None and stop.is_set():
                break
            if max_jobs is not None and served >= max_jobs:
                break
            with span("broker.lease", cat="broker"):
                leased = self.broker.lease(self.worker_id, self.lease_s)
            if leased is None:
                if (max_idle_s is not None
                        and self._clock() - idle_since > max_idle_s):
                    break
                time.sleep(self.poll_s)
                continue
            self.serve_one(*leased)
            served += 1
            idle_since = self._clock()
        for pool in self._pools.values():
            pool.close()
        return served
