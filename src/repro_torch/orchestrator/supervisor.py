"""Self-healing worker fleet: spawn, monitor, restart, scale, drain.

``python -m repro_torch.orchestrator fleet`` runs this supervisor against a broker queue: it keeps
between ``min_workers`` and ``max_workers`` detached ``BrokerWorker``
processes alive, sized from queue depth (pending + leased jobs — the
ROADMAP's "queue depth → spawn/retire" autoscaling item), and turns
worker death from an operator page into a metrics line:

* **Restart with backoff.**  A crashed worker is respawned after
  ``backoff_base_s * 2^(consecutive_failures - 1)``, capped at
  ``backoff_max_s``.  A worker that stays up ``healthy_s`` before dying
  resets its slot's failure streak.
* **Crash-loop quarantine.**  A slot whose worker dies
  ``crash_loop_threshold`` times in a row without a healthy stretch is
  quarantined for ``quarantine_s`` — the fleet stops feeding a poisoned
  host/config instead of burning CPU on a restart storm.
* **Graceful drain.**  SIGTERM/SIGINT (wired up by the CLI) stop the
  supervisor loop, which SIGTERMs every worker; workers finish their
  in-flight job (their own signal handler sets a stop event checked at
  the loop top), then exit 0.  Stragglers past ``drain_grace_s`` are
  SIGKILLed — their leases expire and the jobs requeue.
* **Observability.**  Spawns/restarts/quarantines are recorded as
  counters and fleet size/target as gauges in the broker's durable
  ``metrics`` table under this supervisor's id, so ``status --watch``,
  the ``metrics`` subcommand and ``benchmarks/chaos_bench.py`` all see
  restarts without scraping logs.

Workers inherit ``REPRO_CHAOS`` (or the plan passed as ``chaos_plan``),
plus a per-spawn ``REPRO_CHAOS_SALT`` of ``s<slot>g<generation>`` so
every worker — and every *respawn* — draws a distinct but fully
replayable fault stream (see :mod:`~repro_torch.orchestrator.chaos`).

On a host with cards, the fleet runs at most one worker per card, and
each slot's worker is given its own (``CUDA_VISIBLE_DEVICES``, slot ``i``
the ``i``-th visible card): any job may measure, and two processes timing
configs on one card corrupt both medians.  A larger ``max_workers`` (and
``min_workers``) is clamped to the cards, and the clamp is printed.

``spawn`` is injectable for tests: anything returning a process-like
handle (``poll``/``terminate``/``kill``/``wait``/``pid``) works, so the
backoff/quarantine/scaling policy is unit-testable with fake processes
and a fake clock.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path

from .broker import Broker


def _visible_cards() -> int:
    """How many CUDA devices this host's torch sees (0 without one)."""
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@dataclass
class _Slot:
    """One supervised worker position (the unit of backoff/quarantine)."""

    idx: int
    proc: object | None = None
    worker_id: str | None = None
    generation: int = 0            # spawns so far — the chaos salt
    failures: int = 0              # consecutive crash exits
    next_spawn_at: float = 0.0     # backoff gate (supervisor clock)
    quarantined_until: float = 0.0
    started_at: float = 0.0
    stopping: bool = False         # we sent SIGTERM: exit is a retire

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class FleetSupervisor:
    """Keep a broker's worker fleet at target size; see module docstring."""

    def __init__(self, broker: Broker, *,
                 min_workers: int = 1, max_workers: int = 4,
                 eval_workers: int = 2, mode: str = "auto",
                 lease_s: float = 30.0, poll_s: float = 0.05,
                 job_timeout_s: float | None = None,
                 backoff_base_s: float = 0.5, backoff_max_s: float = 30.0,
                 healthy_s: float = 5.0, crash_loop_threshold: int = 5,
                 quarantine_s: float = 60.0,
                 scale_down_after_s: float = 10.0,
                 drain_grace_s: float = 10.0,
                 interval_s: float = 0.5,
                 chaos_plan: str | None = None,
                 log_dir: str | Path | None = None,
                 devices: int | None = None,
                 spawn=None, clock=time.monotonic, log=None):
        if min_workers < 0 or max_workers < max(1, min_workers):
            raise ValueError(f"bad fleet bounds min={min_workers} "
                             f"max={max_workers}")
        self.broker = broker
        #: cards the slots are spread over (``None``: every visible one)
        self.devices = _visible_cards() if devices is None else devices
        if self.devices and max_workers > self.devices:
            print(f"fleet: {max_workers} workers asked, {self.devices} "
                  f"(one per card)", file=sys.stderr, flush=True)
            max_workers = self.devices
            min_workers = min(min_workers, max_workers)
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.eval_workers = eval_workers
        self.mode = mode
        self.lease_s = lease_s
        self.poll_s = poll_s
        self.job_timeout_s = job_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.healthy_s = healthy_s
        self.crash_loop_threshold = crash_loop_threshold
        self.quarantine_s = quarantine_s
        self.scale_down_after_s = scale_down_after_s
        self.drain_grace_s = drain_grace_s
        self.interval_s = interval_s
        self.chaos_plan = chaos_plan
        self.log_dir = Path(log_dir) if log_dir else None
        self._spawn = spawn or self._spawn_subprocess
        self._clock = clock
        self.log = log or (lambda msg: None)

        host = os.uname().nodename if hasattr(os, "uname") else "host"
        #: metrics identity in the broker's metrics table
        self.sup_id = f"fleet:{host}:{os.getpid()}"
        self.slots = [_Slot(i) for i in range(max_workers)]
        #: lifetime event totals (also recorded as broker counters)
        self.events = {"spawns": 0, "restarts": 0, "clean_exits": 0,
                       "quarantines": 0, "retires": 0}
        self._low_since: float | None = None
        self._last_gauges: tuple | None = None
        self._log_files: list = []

    # -- spawning ---------------------------------------------------------- #
    def _spawn_subprocess(self, slot: _Slot, worker_id: str):
        """Default spawn: a detached ``worker`` subprocess, on its own card
        where there are cards.  Needs a
        file-backed broker (``broker.path``); tests inject thread- or
        fake-process spawns instead."""
        path = getattr(self.broker, "path", None)
        if path is None:
            raise ValueError(
                "default spawn needs a file-backed broker (SQLiteBroker); "
                "pass spawn= for in-memory/test fleets")
        cmd = [sys.executable, "-m", "repro_torch.orchestrator", "worker",
               "--broker", str(path), "--id", worker_id,
               "--workers", str(self.eval_workers), "--mode", self.mode,
               "--lease", str(self.lease_s), "--poll", str(self.poll_s)]
        if self.job_timeout_s is not None:
            cmd += ["--job-timeout", str(self.job_timeout_s)]
        env = dict(os.environ)
        env["PYTHONPATH"] = (str(Path(__file__).resolve().parents[2])
                             + os.pathsep + env.get("PYTHONPATH", ""))
        if self.chaos_plan is not None:
            env["REPRO_CHAOS"] = self.chaos_plan
        env["REPRO_CHAOS_SALT"] = f"s{slot.idx}g{slot.generation}"
        if self.devices:
            cards = [c for c in os.environ.get(
                "CUDA_VISIBLE_DEVICES", "").split(",") if c.strip()] \
                or [str(i) for i in range(self.devices)]
            env["CUDA_VISIBLE_DEVICES"] = cards[slot.idx]
        out = subprocess.DEVNULL
        if self.log_dir is not None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            out = open(self.log_dir
                       / f"worker-s{slot.idx}g{slot.generation}.log", "ab")
            self._log_files.append(out)
        return subprocess.Popen(cmd, env=env, stdout=out, stderr=out)

    def _spawn_into(self, slot: _Slot, now: float) -> None:
        slot.generation += 1
        slot.worker_id = f"{self.sup_id}:s{slot.idx}g{slot.generation}"
        slot.proc = self._spawn(slot, slot.worker_id)
        slot.started_at = now
        slot.stopping = False
        self.events["spawns"] += 1
        self._emit([{"name": "spawns", "value": 1, "kind": "counter"}])
        self.log(f"slot {slot.idx}: spawned {slot.worker_id} "
                 f"(gen {slot.generation})")

    # -- policy ------------------------------------------------------------ #
    def _reap_exits(self, now: float) -> None:
        for slot in self.slots:
            if slot.proc is None or slot.alive():
                continue
            rc = slot.proc.poll()
            uptime = now - slot.started_at
            slot.proc = None
            if slot.stopping or rc == 0:
                # drained on request, or self-retired (--max-idle): not
                # a failure — the slot just becomes spawnable again
                key = "retires" if slot.stopping else "clean_exits"
                slot.stopping = False
                slot.failures = 0
                self.events[key] += 1
                self.log(f"slot {slot.idx}: {slot.worker_id} exited "
                         f"cleanly (rc 0, up {uptime:.1f}s)")
                continue
            slot.failures = 1 if uptime >= self.healthy_s \
                else slot.failures + 1
            backoff = min(self.backoff_base_s * 2 ** (slot.failures - 1),
                          self.backoff_max_s)
            slot.next_spawn_at = now + backoff
            self.events["restarts"] += 1
            samples = [{"name": "restarts", "value": 1, "kind": "counter"}]
            self.log(f"slot {slot.idx}: {slot.worker_id} died (rc {rc}, "
                     f"up {uptime:.1f}s, streak {slot.failures}); "
                     f"backoff {backoff:.1f}s")
            if slot.failures >= self.crash_loop_threshold:
                slot.quarantined_until = now + self.quarantine_s
                slot.failures = 0
                self.events["quarantines"] += 1
                samples.append({"name": "quarantines", "value": 1,
                                "kind": "counter"})
                self.log(f"slot {slot.idx}: crash loop — quarantined "
                         f"{self.quarantine_s:.0f}s")
            self._emit(samples)

    def target_size(self) -> int:
        """Queue depth → fleet size, clamped to [min, max].  Each worker
        serves one job at a time, so depth (pending + leased) *is* the
        demand signal."""
        c = self.broker.counts()
        depth = c.get("pending", 0) + c.get("leased", 0)
        return max(self.min_workers, min(self.max_workers, depth))

    def tick(self) -> None:
        """One supervision step: reap exits, then converge live worker
        count toward :meth:`target_size` (spawn immediately on scale-up
        or death; scale down only after the demand has stayed below the
        fleet size for ``scale_down_after_s`` — no flapping)."""
        now = self._clock()
        self._reap_exits(now)
        target = self.target_size()
        live = [s for s in self.slots if s.alive()]

        if len(live) < target:
            self._low_since = None
            for slot in self.slots:
                if len(live) >= target:
                    break
                if (slot.alive() or slot.stopping
                        or now < slot.quarantined_until
                        or now < slot.next_spawn_at):
                    continue
                self._spawn_into(slot, now)
                live.append(slot)
        elif len(live) > target:
            if self._low_since is None:
                self._low_since = now
            if now - self._low_since >= self.scale_down_after_s:
                # retire the youngest worker (LIFO keeps warm caches on
                # the longest-lived ones), one per tick
                victim = max((s for s in live if not s.stopping),
                             key=lambda s: s.started_at, default=None)
                if victim is not None:
                    victim.stopping = True
                    victim.proc.terminate()
                    self.log(f"slot {victim.idx}: retiring "
                             f"{victim.worker_id} (scale down to {target})")
        else:
            self._low_since = None

        gauges = (len(live), target)
        if gauges != self._last_gauges:
            self._last_gauges = gauges
            self._emit([
                {"name": "fleet_size", "value": gauges[0], "kind": "gauge"},
                {"name": "fleet_target", "value": gauges[1],
                 "kind": "gauge"}])

    # -- run/drain --------------------------------------------------------- #
    def run(self, *, stop: threading.Event | None = None,
            max_runtime_s: float | None = None,
            drain_on_empty_s: float | None = None) -> dict:
        """Supervise until ``stop`` is set (the CLI's signal handlers),
        ``max_runtime_s`` elapses, or — with ``drain_on_empty_s`` — the
        queue has stayed empty that long.  Always drains the fleet on
        the way out; returns the event totals."""
        stop = stop or threading.Event()
        t0 = self._clock()
        empty_since: float | None = None
        try:
            while not stop.is_set():
                self.tick()
                if max_runtime_s is not None \
                        and self._clock() - t0 >= max_runtime_s:
                    break
                if drain_on_empty_s is not None:
                    c = self.broker.counts()
                    busy = (c.get("pending", 0) + c.get("leased", 0)
                            + c.get("done", 0) + c.get("failed", 0))
                    if busy == 0:
                        if empty_since is None:
                            empty_since = self._clock()
                        elif self._clock() - empty_since >= drain_on_empty_s:
                            break
                    else:
                        empty_since = None
                stop.wait(self.interval_s)
        finally:
            self.shutdown()
        return dict(self.events)

    def shutdown(self) -> None:
        """SIGTERM every worker (graceful drain: each finishes its leased
        job), SIGKILL stragglers past ``drain_grace_s``, record the final
        fleet size."""
        for slot in self.slots:
            if slot.alive():
                slot.stopping = True
                slot.proc.terminate()
        deadline = time.monotonic() + self.drain_grace_s
        for slot in self.slots:
            if slot.proc is None:
                continue
            try:
                slot.proc.wait(timeout=max(0.0,
                                           deadline - time.monotonic()))
            except Exception:
                slot.proc.kill()     # lease expiry requeues its job
                try:
                    slot.proc.wait(timeout=5.0)
                except Exception:
                    pass
            self.events["retires"] += 1
            slot.proc = None
        for f in self._log_files:
            try:
                f.close()
            except Exception:
                pass
        self._log_files.clear()
        self._emit([{"name": "fleet_size", "value": 0, "kind": "gauge"}])

    def status(self) -> list[dict]:
        now = self._clock()
        return [{"slot": s.idx, "worker": s.worker_id,
                 "alive": s.alive(), "generation": s.generation,
                 "failures": s.failures,
                 "quarantined": now < s.quarantined_until,
                 "uptime": (now - s.started_at) if s.alive() else None}
                for s in self.slots]

    def _emit(self, samples: list[dict]) -> None:
        try:
            self.broker.record_metrics(self.sup_id, samples)
        except Exception as e:   # metrics must never take down the fleet
            self.log(f"supervisor metrics record failed: {e!r}")
