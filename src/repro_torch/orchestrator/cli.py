"""Command-line front end: ``python -m repro_torch.orchestrator`` (or
``repro-torch``).

Subcommands::

    submit   — register a session in a store and run it
    status   — show every session in a store (or one, with its curve tail);
               --watch for a live ANSI dashboard, --json for machines
    resume   — continue an interrupted session from its journal
    campaign — run a whole grid (problems × tuners × archs × seeds),
               interleaved on one shared worker pool or a broker fleet
    worker   — serve a broker job queue as one detached worker process
    fleet    — supervise a self-healing fleet of worker processes:
               restart-with-backoff, crash-loop quarantine, queue-depth
               autoscaling between --min/--max, SIGTERM = graceful drain;
               on a host with cards each worker gets its own
    metrics  — dump or tail a broker fleet's aggregate metrics as JSON
    doctor   — offline integrity check of a store (+ broker): torn
               journal lines, orphaned RUNNING sessions, stale leases;
               --servedb adds find-DB snapshot triage, --lint folds in the
               contract checks
    servedb  — the tuned-config serving layer: build (distill campaign
               traces into an atomically-published, checksummed
               snapshot), query (the never-raise degradation chain),
               verify (offline snapshot/quarantine triage)
    surrogate — transfer-aware performance models trained on journaled
               campaign history: train (harvest a session store into
               per-kernel GBDT models, published to a checksummed model
               store), predict (rank an arch's space — the warm-start
               rows), eval (held-out-arch R² against a shuffled-label
               baseline + top-param report)
    lint     — static contract checks (wall-clock/RNG in deterministic
               seams, chaos-site registry, telemetry naming, journal
               grammar, broker transactions, retry policy) over the
               ``repro_torch`` package, plus --spaces search-space audits
               (every registered problem, built on the CPU); --strict is
               the CI gate

Problems are the port's eight kernels (``gemm_h100`` ...
``flash_attention_h100``) and two toys.  A kernel problem runs on the card
unless ``--device cpu`` is given; with no card and no ``--device`` it
raises.  ``--arch`` (default ``h100``, the card's id) picks the evaluator:
the device's own id measures each config (CUDA events, cold L2, median),
one measuring process per card; ``h100sxm`` and ``h100pcie`` are the
Hopper cost model, host arithmetic.  On the host, ``--device cpu --arch
cpu`` times the plain PyTorch versions::

    python -m repro_torch.orchestrator submit --problem gemm_h100 \\
        --tuner genetic --budget 200 --seed 0 --store experiments/sessions
    python -m repro_torch.orchestrator status --store experiments/sessions
    python -m repro_torch.orchestrator resume <session-id> \\
        --store experiments/sessions

    # the cost model, on any host:
    python -m repro_torch.orchestrator submit --problem conv2d_h100 \\
        --tuner random --arch h100sxm --device cpu --budget 500 \\
        --store experiments/sessions

Live views and machine-readable output::

    # ANSI refresh loop: progress bars, best-so-far sparklines, worker
    # lease/heartbeat health (with --broker); ctrl-C to stop
    python -m repro_torch.orchestrator status --store experiments/sessions \\
        --watch

    # one JSON object per session on stdout (same columns as the table)
    python -m repro_torch.orchestrator status --store experiments/sessions \\
        --json

    # aggregate fleet metrics (queue depth, per-worker throughput) as JSON;
    # --tail re-emits every --interval seconds
    python -m repro_torch.orchestrator metrics --broker experiments/queue.db

Span tracing: pass ``--trace FILE`` to submit/resume/campaign/worker to
record spans (ask/tell, pool chunks, journal writes, broker round-trips,
and the measuring processes' ``kernel.build``/``kernel.measure``, tagged
with their pid) and export them on exit — Chrome ``chrome://tracing``
format for ``.json`` paths, the JSONL grammar otherwise.

A portability campaign mixes the card's id with the cost model's: each
row the ``h100`` sessions ask is measured once for all of them, and the
model's ids share one columnar sweep::

    python -m repro_torch.orchestrator campaign \\
        --problems flash_attention_h100 --tuners random,genetic \\
        --archs h100,h100sxm,h100pcie --seeds 0,1 --budget 100 \\
        --store experiments/sessions

Multi-host campaigns run the same grid against a durable SQLite job queue
(any filesystem the hosts share) served by detached workers — start any
number of workers, on any machine, before or after the driver; kill and
restart them freely.  Trajectories, journals, and published traces are
bit-identical to the in-process run::

    python -m repro_torch.orchestrator worker --broker experiments/queue.db \\
        --max-idle 60
    python -m repro_torch.orchestrator campaign --problems gemm_h100 \\
        --tuners genetic --archs h100sxm,h100pcie --device cpu --budget 200 \\
        --store experiments/sessions --broker experiments/queue.db
    python -m repro_torch.orchestrator fleet --broker experiments/queue.db \\
        --min 1 --max 4 --job-timeout 300

Campaign state health (read-only; exit 1 when problems are found)::

    python -m repro_torch.orchestrator doctor --store experiments/sessions \\
        --broker experiments/queue.db --json

Contract checks and space audits, on any host (exit 1 on a finding)::

    python -m repro_torch.orchestrator lint --strict --spaces

Chaos engineering: ``--chaos PLAN.json`` (or ``REPRO_CHAOS``) arms the
deterministic fault-injection plane — seeded schedules of worker
crashes, evaluation hangs, heartbeat stalls, torn journal appends, lock
storms and clock skew at named sites (see ``chaos.SITES``), replayable
exactly.

Tuned-config serving (the find-DB): distill finished campaign traces
into per-(kernel, arch) golden tables, published as one atomic,
checksummed snapshot; answer "best config for (kernel, shape, arch)"
through the never-raise degradation chain (exact → nearest-shape →
heuristic → static default, the tier recorded in the result and in
telemetry); triage torn or bit-rotted snapshots offline.  The builder
reads each session's problem on the CPU, and a lookup never measures (a
cost-model pick for the card's ``h100`` asks ``h100sxm``)::

    python -m repro_torch.orchestrator servedb build \
        --store experiments/sessions --db experiments/servedb
    python -m repro_torch.orchestrator servedb query \
        --db experiments/servedb --kernel flash_attention_h100 \
        --shape '{"hq":32,"hkv":8,"tq":4096,"tk":4096,"d":128}'
    python -m repro_torch.orchestrator servedb verify --db experiments/servedb
    python -m repro_torch.orchestrator doctor --store experiments/sessions \
        --servedb experiments/servedb

Transfer-aware warm starts: distill every journaled session of a store
into per-kernel surrogate models (codes + arch-ordinal GBDTs over the
card's ``h100`` and the cost model's ids, serialized with checksummed
headers and quarantine-on-corrupt, like servedb), then seed new sessions
from the model's predicted-top rows.  The resolved row list becomes part
of the spec identity, so resume replays the same warm queue even after a
retrain::

    python -m repro_torch.orchestrator surrogate train \
        --store experiments/sessions --models experiments/models
    python -m repro_torch.orchestrator surrogate predict \
        --models experiments/models --problem gemm_h100 --arch h100 --top 8
    python -m repro_torch.orchestrator surrogate eval \
        --store experiments/sessions --problem gemm_h100 --holdout h100
    python -m repro_torch.orchestrator submit --problem gemm_h100 \
        --tuner genetic --budget 200 --store experiments/sessions \
        --warm-start experiments/models --warm-top 8

Per-tuner settings ride the spec: ``--tuner-arg k=v`` (repeatable, JSON
values) merges into every session's ``tuner_kwargs``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from ..core.problem import DEFAULT_ARCH
from .registry import problem_names
from .runner import resume_session, run_session
from .session import SessionSpec
from .store import SessionStore


def _fmt_best(best) -> str:
    if best is None or not math.isfinite(best):
        return "-"
    return f"{best * 1e3:.4f}ms" if best < 1.0 else f"{best:.4f}s"


def _fmt_age(seconds: float) -> str:
    """Humanized duration: ``3.2s`` / ``4.1m`` / ``2.3h``."""
    if seconds < 120:
        return f"{seconds:.1f}s"
    if seconds < 7200:
        return f"{seconds / 60:.1f}m"
    return f"{seconds / 3600:.1f}h"


def _leases_by_session(broker) -> dict[str, tuple[str, float, bool]]:
    """``{session id: (worker, heartbeat age, stale)}`` from in-flight
    broker jobs — freshest heartbeat wins when several jobs carry one
    session."""
    out: dict[str, tuple[str, float, bool]] = {}
    for j in broker.in_flight():
        for sid in j["sessions"]:
            if sid not in out or j["heartbeat_age"] < out[sid][1]:
                out[sid] = (j["worker"], j["heartbeat_age"],
                            bool(j.get("stale")))
    return out


def _session_rows(store: SessionStore, sids: list[str],
                  broker=None) -> list[dict]:
    """One dict per session — the single source for the table, ``--json``
    and ``--watch`` renderings."""
    leases = _leases_by_session(broker) if broker is not None else {}
    rows = []
    for s in sids:
        m = store.meta(s)
        row = {"session": s, "status": m["status"],
               "evaluated": m.get("evaluated", 0),
               "budget": m["spec"]["budget"], "best": m.get("best")}
        if broker is not None:
            if s in leases:
                worker, age, stale = leases[s]
                row.update(worker=worker, heartbeat_age=age, stale=stale)
            else:
                row.update(worker=None, heartbeat_age=None, stale=False)
        rows.append(row)
    return rows


def _lease_cell(row: dict) -> str:
    if row.get("worker") is not None:
        age = _fmt_age(row["heartbeat_age"])
        if row.get("stale"):
            return f" {row['worker']} (STALE >lease; {age} ago)"
        return f" {row['worker']} ({age} ago)"
    if row["status"] == "running":
        # running in the store but no live lease: the batch is
        # queued (or its worker just died and the job is requeued)
        return " (queued)"
    return ""


def _render_status(rows: list[dict], with_broker: bool) -> str:
    hdr = f"{'session':58s} {'status':12s} {'progress':>12s} {'best':>12s}"
    if with_broker:
        hdr += f" {'leased by (heartbeat)':30s}"
    lines = [hdr, "-" * len(hdr)]
    for row in rows:
        prog = f"{row['evaluated']}/{row['budget']}"
        line = (f"{row['session']:58s} {row['status']:12s} {prog:>12s} "
                f"{_fmt_best(row['best']):>12s}")
        if with_broker:
            line += _lease_cell(row)
        lines.append(line)
    return "\n".join(lines)


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _best_curve_spark(store: SessionStore, sid: str, width: int = 24) -> str:
    """Best-so-far objective curve from the session journal as a unicode
    sparkline (left = first evaluation; lower block = better).  Reads only
    journal ``"o"`` values — no space needed, cheap enough to poll."""
    p = store._journal_path(sid)
    if not p.exists():
        return ""
    best = math.inf
    curve: list[float] = []
    for line in p.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue                   # torn line from a crash mid-append
        o = rec.get("o")
        if o is not None and o < best:
            best = o
        if math.isfinite(best):
            curve.append(best)
    if not curve:
        return ""
    n = min(width, len(curve))
    pts = [curve[round(i * (len(curve) - 1) / max(n - 1, 1))]
           for i in range(n)]
    lo, hi = min(pts), max(pts)
    if hi <= lo:
        return _SPARK_BLOCKS[0] * n
    return "".join(_SPARK_BLOCKS[round((v - lo) / (hi - lo) * 7)]
                   for v in pts)


def _progress_bar(evaluated: int, budget: int, width: int = 20) -> str:
    frac = min(1.0, evaluated / budget) if budget else 0.0
    filled = round(frac * width)
    return "[" + "#" * filled + "." * (width - filled) + "]"


def _render_watch(store: SessionStore, sids: list[str], broker,
                  interval: float) -> str:
    """One dashboard frame: per-session progress bars + best-so-far
    sparklines, plus queue depth and per-worker lease/heartbeat health
    when a broker is attached."""
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    out = [f"repro_torch status — {stamp} (refresh {interval:g}s, ctrl-C to stop)"]
    if broker is not None:
        c = broker.counts()
        out.append(f"queue: pending {c.get('pending', 0)}  "
                   f"leased {c.get('leased', 0)}  done {c.get('done', 0)}  "
                   f"failed {c.get('failed', 0)}")
    out.append("")
    rows = _session_rows(store, sids, broker)
    for row in rows:
        bar = _progress_bar(row["evaluated"], row["budget"])
        prog = f"{row['evaluated']}/{row['budget']}"
        spark = _best_curve_spark(store, row["session"])
        line = (f"{row['session']:58s} {row['status']:12s} {bar} "
                f"{prog:>11s} {_fmt_best(row['best']):>12s}  {spark}")
        if broker is not None:
            line += _lease_cell(row)
        out.append(line)
    if broker is not None:
        from ..telemetry.metrics import fleet_snapshot
        snap = fleet_snapshot(broker)
        if snap["workers"]:
            out.append("")
            out.append("workers:")
            for w, d in sorted(snap["workers"].items()):
                health = "STALE >lease" if d.get("stale") else "OK"
                hb = (f"heartbeat {_fmt_age(d['heartbeat_age'])} ago"
                      if d.get("heartbeat_age") is not None else "idle")
                rate = d.get("configs_per_s")
                rate_s = f"  {rate:.0f} cfg/s" if rate else ""
                # robustness counters, shown only when nonzero: watchdog
                # fires, abandoned batches, supervisor restart activity
                extra = "".join(
                    f"  {k} {int(d[k])}"
                    for k in ("timeouts", "abandoned", "restarts",
                              "quarantines", "fleet_size")
                    if d.get(k))
                out.append(f"  {w}  leases {d.get('leases', 0)}  {hb}  "
                           f"{health}{rate_s}{extra}")
    return "\n".join(out)


def _print_status(store: SessionStore, sid: str | None, broker=None, *,
                  as_json: bool = False, watch: bool = False,
                  interval: float = 2.0, count: int | None = None) -> int:
    if sid and not store.exists(sid):
        print(f"error: no session {sid!r} in {store.root}", file=sys.stderr)
        return 2
    sids = [sid] if sid else store.list_sessions()
    if not sids and not watch:
        print(f"(no sessions under {store.root})")
        return 0
    if watch:
        frames = 0
        try:
            while True:
                frame = _render_watch(store,
                                      [sid] if sid else store.list_sessions(),
                                      broker, interval)
                # curses-free ANSI refresh: clear screen, home cursor
                print("\x1b[2J\x1b[H" + frame, flush=True)
                frames += 1
                if count is not None and frames >= count:
                    return 0
                time.sleep(interval)
        except KeyboardInterrupt:      # pragma: no cover — interactive
            return 0
    rows = _session_rows(store, sids, broker)
    if as_json:
        for row in rows:
            print(json.dumps(row, separators=(",", ":")))
        return 0
    print(_render_status(rows, with_broker=broker is not None))
    return 0


def _run_metrics(broker, *, raw: bool = False, tail: bool = False,
                 interval: float = 2.0, count: int | None = None) -> int:
    """``metrics`` subcommand body: dump (or tail) the fleet aggregate."""
    from ..telemetry.metrics import fleet_snapshot
    emitted = 0
    while True:
        if raw:
            for s in broker.read_metrics():
                print(json.dumps(s, separators=(",", ":")))
        else:
            print(json.dumps(fleet_snapshot(broker),
                             separators=(",", ":")), flush=True)
        emitted += 1
        if not tail or (count is not None and emitted >= count):
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:      # pragma: no cover — interactive
            return 0


def _parse_tuner_args(pairs: list[str], base: dict) -> dict:
    """Merge repeatable ``--tuner-arg k=v`` pairs (JSON values, bare
    strings accepted) over ``base``."""
    out = dict(base)
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--tuner-arg needs k=v, got {pair!r}")
        k, _, v = pair.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v                 # bare string value
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.orchestrator",
        description="distributed tuning-session orchestrator")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_sub = sub.add_parser("submit", help="register a session and run it")
    p_sub.add_argument("--problem", required=True,
                       help=f"one of: {', '.join(problem_names())}")
    p_sub.add_argument("--tuner", required=True,
                       help="registered tuner name (e.g. random, genetic)")
    p_sub.add_argument("--arch", default=DEFAULT_ARCH,
                       help="the card's id (measured; default %(default)s) "
                            "or a cost-model id (h100sxm, h100pcie)")
    p_sub.add_argument("--device", default=None,
                       help="where a kernel problem runs: the card "
                            "(default; raises with none) or cpu (the plain "
                            "versions, or the cost model's arch ids)")
    p_sub.add_argument("--problem-kwargs", default="{}",
                       help="JSON dict of problem constructor kwargs (e.g. "
                            "'{\"shape\": {\"m\": 256, \"n\": 256, "
                            "\"k\": 512}}')")
    p_sub.add_argument("--budget", type=int, default=100)
    p_sub.add_argument("--seed", type=int, default=0)
    p_sub.add_argument("--workers", type=int, default=4)
    p_sub.add_argument("--mode", default="auto",
                       choices=("auto", "thread", "process"))
    p_sub.add_argument("--max-retries", type=int, default=2)
    p_sub.add_argument("--store", required=True, help="session store dir")
    p_sub.add_argument("--tuner-kwargs", default="{}",
                       help="JSON dict of tuner constructor kwargs")
    p_sub.add_argument("--stop-after", type=int, default=None,
                       help="checkpoint-and-stop after N trials")
    p_sub.add_argument("--warm-start", default=None, metavar="MODELS",
                       help="surrogate model-store dir: seed the session "
                            "with the model's predicted-top rows for "
                            "--arch (resolved now, stored in the spec)")
    p_sub.add_argument("--warm-top", type=int, default=8,
                       help="how many predicted-top rows to warm-start "
                            "with (default 8)")
    p_sub.add_argument("--chaos", default=None, metavar="PLAN",
                       help="fault-injection plan (JSON file path or inline "
                            "JSON): arm the deterministic chaos plane in "
                            "this process")
    p_sub.add_argument("--trace", default=None, metavar="FILE",
                       help="record telemetry spans; export on exit "
                            "(.json => chrome://tracing, else JSONL)")

    p_st = sub.add_parser("status", help="show sessions in a store")
    p_st.add_argument("session", nargs="?", default=None)
    p_st.add_argument("--store", required=True)
    p_st.add_argument("--broker", default=None,
                      help="broker db: also show lease holder + heartbeat "
                           "age for sessions being served by the fleet")
    p_st.add_argument("--json", action="store_true",
                      help="one JSON object per session (the table's "
                           "columns, machine-readable)")
    p_st.add_argument("--watch", action="store_true",
                      help="live ANSI dashboard: progress bars, best-so-far "
                           "sparklines, worker health; refresh --interval")
    p_st.add_argument("--interval", type=float, default=2.0,
                      help="--watch refresh period, seconds")
    p_st.add_argument("--count", type=int, default=None,
                      help="--watch: exit after N frames (default: forever)")

    p_re = sub.add_parser("resume", help="continue an interrupted session")
    p_re.add_argument("session")
    p_re.add_argument("--store", required=True)
    p_re.add_argument("--workers", type=int, default=None,
                      help="override evaluation parallelism (trajectory is "
                           "unchanged; batches are set by the tuner)")
    p_re.add_argument("--trace", default=None, metavar="FILE",
                      help="record telemetry spans; export on exit "
                           "(.json => chrome://tracing, else JSONL)")

    p_ca = sub.add_parser(
        "campaign",
        help="run a session grid interleaved on one shared pool")
    p_ca.add_argument("--problems", required=True,
                      help="comma-separated problem names")
    p_ca.add_argument("--tuners", required=True,
                      help="comma-separated tuner names")
    p_ca.add_argument("--archs", default=DEFAULT_ARCH,
                      help="comma-separated architectures (several archs on "
                           "one problem => arch-shared evaluation)")
    p_ca.add_argument("--device", default=None,
                      help="where the kernel problems run (see submit)")
    p_ca.add_argument("--problem-kwargs", default="{}",
                      help="JSON dict of problem constructor kwargs")
    p_ca.add_argument("--seeds", default="0",
                      help="comma-separated seeds")
    p_ca.add_argument("--budget", type=int, default=100)
    p_ca.add_argument("--workers", type=int, default=4)
    p_ca.add_argument("--mode", default="auto",
                      choices=("auto", "thread", "process"))
    p_ca.add_argument("--max-retries", type=int, default=2)
    p_ca.add_argument("--store", required=True, help="session store dir")
    p_ca.add_argument("--tuner-kwargs", default="{}",
                      help="JSON dict of tuner constructor kwargs")
    p_ca.add_argument("--tuner-arg", action="append", default=[],
                      metavar="K=V",
                      help="per-tuner kwarg (repeatable, JSON values); "
                           "merged over --tuner-kwargs into every spec")
    p_ca.add_argument("--serial", action="store_true",
                      help="run sessions one at a time (own pool each) "
                           "instead of interleaving on a shared pool")
    p_ca.add_argument("--no-share-archs", action="store_true",
                      help="disable arch-shared evaluation even for "
                           "multi-arch grids")
    p_ca.add_argument("--broker", default=None,
                      help="SQLite job-queue db: dispatch evaluation to "
                           "detached `worker` processes (async tell) "
                           "instead of an in-process pool")
    p_ca.add_argument("--chaos", default=None, metavar="PLAN",
                      help="fault-injection plan (JSON file path or inline "
                           "JSON): arm the deterministic chaos plane in "
                           "this process")
    p_ca.add_argument("--trace", default=None, metavar="FILE",
                      help="record telemetry spans; export on exit "
                           "(.json => chrome://tracing, else JSONL)")

    p_wo = sub.add_parser(
        "worker",
        help="serve a broker job queue as one detached worker process")
    p_wo.add_argument("--broker", required=True,
                      help="SQLite job-queue db (shared filesystem path)")
    p_wo.add_argument("--workers", type=int, default=2,
                      help="evaluation threads/processes inside this worker")
    p_wo.add_argument("--mode", default="auto",
                      choices=("auto", "thread", "process"))
    p_wo.add_argument("--max-retries", type=int, default=2,
                      help="per-config poison cap inside a batch")
    p_wo.add_argument("--lease", type=float, default=30.0,
                      help="job lease seconds (heartbeats renew at 1/3)")
    p_wo.add_argument("--poll", type=float, default=0.05,
                      help="idle queue poll interval, seconds")
    p_wo.add_argument("--max-idle", type=float, default=None,
                      help="exit after this many idle seconds (default: "
                           "serve forever)")
    p_wo.add_argument("--max-jobs", type=int, default=None,
                      help="exit after serving N jobs")
    p_wo.add_argument("--id", default=None,
                      help="worker id shown in status (default host:pid)")
    p_wo.add_argument("--job-timeout", type=float, default=None,
                      help="evaluation watchdog: wall-clock seconds per "
                           "job batch / per-config retry attempt; a hung "
                           "measurement becomes a journaled timeout-poison "
                           "trial (default: wait forever)")
    p_wo.add_argument("--chaos", default=None, metavar="PLAN",
                      help="fault-injection plan (JSON file path or inline "
                           "JSON): arm the deterministic chaos plane in "
                           "this process")
    p_wo.add_argument("--trace", default=None, metavar="FILE",
                      help="record telemetry spans; export on exit "
                           "(.json => chrome://tracing, else JSONL)")

    p_fl = sub.add_parser(
        "fleet",
        help="supervise a self-healing fleet of worker processes")
    p_fl.add_argument("--broker", required=True,
                      help="SQLite job-queue db (shared filesystem path)")
    p_fl.add_argument("--min", type=int, default=1, dest="min_workers",
                      help="minimum live worker processes")
    p_fl.add_argument("--max", type=int, default=4, dest="max_workers",
                      help="maximum live worker processes")
    p_fl.add_argument("--workers", type=int, default=2,
                      help="evaluation threads/processes inside each worker")
    p_fl.add_argument("--mode", default="auto",
                      choices=("auto", "thread", "process"))
    p_fl.add_argument("--lease", type=float, default=30.0,
                      help="job lease seconds passed to each worker")
    p_fl.add_argument("--poll", type=float, default=0.05,
                      help="worker idle queue poll interval, seconds")
    p_fl.add_argument("--job-timeout", type=float, default=None,
                      help="evaluation watchdog budget passed to each "
                           "worker (seconds)")
    p_fl.add_argument("--backoff", type=float, default=0.5,
                      help="base restart backoff, seconds (doubles per "
                           "consecutive fast crash)")
    p_fl.add_argument("--crash-loop", type=int, default=5,
                      help="consecutive fast crashes before a slot is "
                           "quarantined")
    p_fl.add_argument("--quarantine", type=float, default=60.0,
                      help="quarantine hold, seconds")
    p_fl.add_argument("--scale-down-after", type=float, default=10.0,
                      help="retire surplus workers only after demand has "
                           "been below fleet size this many seconds")
    p_fl.add_argument("--interval", type=float, default=0.5,
                      help="supervisor tick period, seconds")
    p_fl.add_argument("--chaos", default=None, metavar="PLAN",
                      help="fault-injection plan (JSON file path or inline "
                           "JSON), exported to every spawned worker via "
                           "REPRO_CHAOS")
    p_fl.add_argument("--log-dir", default=None,
                      help="per-worker stdout/stderr log files (default: "
                           "discard)")
    p_fl.add_argument("--max-runtime", type=float, default=None,
                      help="stop supervising after this many seconds")
    p_fl.add_argument("--drain-after", type=float, default=None,
                      help="exit once the queue has been empty this many "
                           "seconds")

    p_me = sub.add_parser(
        "metrics",
        help="dump or tail a broker fleet's aggregate metrics as JSON")
    p_me.add_argument("--broker", required=True,
                      help="SQLite job-queue db (shared filesystem path)")
    p_me.add_argument("--raw", action="store_true",
                      help="emit the raw per-job samples instead of the "
                           "aggregate snapshot")
    p_me.add_argument("--tail", action="store_true",
                      help="keep emitting (one snapshot per line) every "
                           "--interval seconds")
    p_me.add_argument("--interval", type=float, default=2.0,
                      help="--tail emit period, seconds")
    p_me.add_argument("--count", type=int, default=None,
                      help="--tail: exit after N snapshots "
                           "(default: forever)")

    p_dr = sub.add_parser(
        "doctor",
        help="offline integrity check of a session store (+ broker)")
    p_dr.add_argument("--store", required=True, help="session store dir")
    p_dr.add_argument("--broker", default=None,
                      help="broker db: also check leases, failed jobs and "
                           "metrics-table sanity")
    p_dr.add_argument("--servedb", default=None, metavar="DB",
                      help="find-DB dir: also triage servedb snapshots "
                           "(checksum verdicts, quarantine listing)")
    p_dr.add_argument("--lint", action="store_true",
                      help="also run the staticcheck contract rules over "
                           "the installed repro_torch package and fold "
                           "findings into the problem list")
    p_dr.add_argument("--json", action="store_true",
                      help="emit the full report as one JSON object")

    p_sv = sub.add_parser(
        "servedb",
        help="build / query / verify the tuned-config find-DB")
    p_sv.add_argument("action", choices=("build", "query", "verify"),
                      help="build: distill a session store into an atomic "
                           "snapshot; query: one lookup through the "
                           "degradation chain; verify: offline snapshot "
                           "triage (exit 1 on problems)")
    p_sv.add_argument("--db", required=True,
                      help="find-DB directory (snapshot + quarantine)")
    p_sv.add_argument("--store", default=None,
                      help="build: session store to distill from")
    p_sv.add_argument("--ttl", type=float, default=None,
                      help="build: snapshot time-to-live in seconds "
                           "(lookups past it degrade and flag stale; "
                           "default: never stale)")
    p_sv.add_argument("--include", default="session",
                      help="build: comma-separated ResultsDB protocol "
                           "prefixes to distill (default: session traces "
                           "only; add exhaustive,sampled for the paper's "
                           "full-space tables)")
    p_sv.add_argument("--no-binary", action="store_true",
                      help="build: skip the npz row-encoded binary export")
    p_sv.add_argument("--kernel", default=None,
                      help="query: kernel table name (e.g. "
                           "flash_attention_h100, gemm_h100)")
    p_sv.add_argument("--arch", default=DEFAULT_ARCH,
                      help="query: architecture key (default %(default)s, "
                           "the card's id)")
    p_sv.add_argument("--shape", default=None, metavar="JSON",
                      help="query: problem shape as a JSON dict "
                           "(default: {} — matches the nearest entry)")
    p_sv.add_argument("--stale-ok", action="store_true",
                      help="query: serve flagged-stale table hits instead "
                           "of degrading past a stale snapshot")
    p_sv.add_argument("--json", action="store_true",
                      help="machine-readable output")

    p_su = sub.add_parser(
        "surrogate",
        help="train / query / evaluate transfer-aware surrogate models")
    p_su.add_argument("action", choices=("train", "predict", "eval"),
                      help="train: harvest a session store into per-kernel "
                           "models; predict: rank a target architecture's "
                           "space (the warm-start rows); eval: held-out-"
                           "arch R2 vs a shuffled-label baseline "
                           "(exit 1 when the model does not transfer)")
    p_su.add_argument("--models", default="experiments/models",
                      help="model-store directory (checksummed *.model.json "
                           "+ quarantine)")
    p_su.add_argument("--store", default=None,
                      help="train/eval: session store to harvest")
    p_su.add_argument("--problem", default=None,
                      help="kernel name(s); train: comma-separated, "
                           "default all registered")
    p_su.add_argument("--arch", default=DEFAULT_ARCH,
                      help="predict: target architecture to rank for "
                           "(default %(default)s, the card's id)")
    p_su.add_argument("--holdout", default=DEFAULT_ARCH,
                      help="eval: architecture held out of training "
                           "(default %(default)s: the cost model's ids "
                           "predict the card)")
    p_su.add_argument("--top", type=int, default=8,
                      help="predict: how many rows to emit")
    p_su.add_argument("--min-rows", type=int, default=32,
                      help="train: skip kernels with fewer harvested rows")
    p_su.add_argument("--exclude-arch", default=None,
                      help="train: comma-separated archs to leave out of "
                           "the harvest (deliberate holdout)")
    p_su.add_argument("--params", default="{}",
                      help="train: JSON dict of GBDT hyperparameter "
                           "overrides")
    p_su.add_argument("--seed", type=int, default=0,
                      help="eval: shuffled-label baseline permutation seed")
    p_su.add_argument("--json", action="store_true",
                      help="machine-readable output")

    p_li = sub.add_parser(
        "lint",
        help="static contract checks + search-space audit")
    p_li.add_argument("paths", nargs="*", metavar="PATH",
                      help="files/directories to lint (default: the "
                           "installed repro_torch package)")
    p_li.add_argument("--strict", action="store_true",
                      help="exit 1 on any non-baselined finding (CI gate); "
                           "default is advisory (always exit 0)")
    p_li.add_argument("--baseline", default=None, metavar="JSON",
                      help="tolerate the findings recorded in this "
                           "baseline file, report only new ones")
    p_li.add_argument("--write-baseline", default=None, metavar="JSON",
                      help="record the current findings to JSON and exit 0 "
                           "(how a baseline is [re]generated)")
    p_li.add_argument("--spaces", action="store_true",
                      help="also audit every registered problem's search "
                           "space, built on the CPU (dead values, "
                           "unsatisfiable/redundant constraints, Hamming-1 "
                           "connectivity)")
    p_li.add_argument("--json", action="store_true",
                      help="machine-readable output")

    args = ap.parse_args(argv)

    if getattr(args, "trace", None):
        # enable both layers before any work, export the ring buffer on
        # the way out (even when the command fails — a trace of the
        # failure is the point)
        from .. import telemetry
        from ..telemetry import trace as trace_mod
        telemetry.enable()
        try:
            return _dispatch(args)
        finally:
            if args.trace.endswith(".json"):
                path = trace_mod.export_chrome(args.trace)
            else:
                path = trace_mod.export_jsonl(args.trace)
            # scope the enable to this command: in-process callers (tests,
            # notebooks) must not inherit a globally-enabled tracer
            telemetry.disable()
            print(f"trace written to {path}", file=sys.stderr)
    return _dispatch(args)


def _problem_kwargs(args) -> dict:
    """``--problem-kwargs`` with ``--device`` over it; no ``device`` when
    both leave it out, so the problem takes its default, the card."""
    out = json.loads(args.problem_kwargs)
    if args.device is not None:
        out["device"] = args.device
    return out


def _render_servedb_verify(report: dict) -> str:
    """Human rendering of :func:`repro_torch.servedb.snapshot.verify_dir` —
    one verdict line per snapshot artifact."""
    lines = [f"servedb: {report['root']}"]
    for s in report["snapshots"]:
        if s["status"] == "corrupt":
            lines.append(f"  {s['file']:24s} CORRUPT  {s['error']}")
        else:
            verdict = s["status"].upper().ljust(8)
            lines.append(
                f"  {s['file']:24s} {verdict} gen {s['generation']} "
                f"{s['kernels']} kernel(s) {s['entries']} entr"
                f"{'y' if s['entries'] == 1 else 'ies'}"
                + (f"  binary {'ok' if s['binary_ok'] else 'BAD'}"
                   if "binary_ok" in s else ""))
    for q in report["quarantined"]:
        lines.append(f"  quarantine/{q['file']:24s} ({q['reason']})")
    if report["problems"]:
        lines.append(f"problems ({len(report['problems'])}):")
        lines.extend(f"  - {p}" for p in report["problems"])
    else:
        lines.append("no problems found")
    return "\n".join(lines)


def _run_servedb(args) -> int:
    """``servedb`` subcommand body: build | query | verify."""
    from ..servedb import ServeDB, verify_dir
    if args.action == "build":
        if not args.store:
            print("error: servedb build needs --store", file=sys.stderr)
            return 2
        from ..servedb.distill import build_snapshot
        from ..servedb.snapshot import publish
        snap, binary, problems = build_snapshot(
            args.store, ttl_s=args.ttl,
            include_protocols=tuple(p for p in args.include.split(",") if p),
            with_binary=not args.no_binary)
        for p in problems:
            print(f"warning: {p}", file=sys.stderr)
        path = publish(snap, args.db, binary_bytes=binary)
        if args.json:
            print(json.dumps(
                {"db": args.db, "generation": snap.generation,
                 "kernels": snap.kernels(), "entries": snap.n_entries(),
                 "binary": snap.binary, "build_problems": problems},
                separators=(",", ":")))
        else:
            print(f"servedb: published generation {snap.generation} "
                  f"({snap.n_entries()} entr"
                  f"{'y' if snap.n_entries() == 1 else 'ies'} across "
                  f"{len(snap.kernels())} kernel(s)) to {path}")
        return 0
    if args.action == "query":
        if not args.kernel:
            print("error: servedb query needs --kernel", file=sys.stderr)
            return 2
        try:
            shape = json.loads(args.shape) if args.shape else {}
        except json.JSONDecodeError as e:
            print(f"error: --shape is not valid JSON: {e}", file=sys.stderr)
            return 2
        db = ServeDB(args.db, serve_stale=args.stale_ok)
        res = db.lookup(args.kernel, shape, args.arch)
        if args.json:
            print(json.dumps(
                {"kernel": res.kernel, "arch": res.arch, "shape": res.shape,
                 "config": res.config, "tier": res.tier,
                 "detail": res.detail, "objective": res.objective,
                 "matched_shape": res.matched_shape,
                 "distance": res.distance, "stale": res.stale,
                 "generation": res.generation}, separators=(",", ":")))
        else:
            prov = f" [{res.detail}]" if res.detail else ""
            flags = " (STALE snapshot)" if res.stale else ""
            print(f"{res.kernel} @ {res.arch}: tier={res.tier}{prov}{flags}")
            print(f"  config {json.dumps(res.config, sort_keys=True)}")
            if res.objective is not None:
                print(f"  objective {_fmt_best(res.objective)}"
                      + (f"  donor shape {json.dumps(res.matched_shape)}"
                         f" (distance {res.distance:.2f})"
                         if res.tier != "exact" else ""))
        return 0
    # verify
    report = verify_dir(args.db)
    if args.json:
        print(json.dumps(report, separators=(",", ":")))
    else:
        print(_render_servedb_verify(report))
    return 0 if report["ok"] else 1


def _run_surrogate(args) -> int:
    """``surrogate`` subcommand body: train | predict | eval."""
    from ..core.surrogate import Harvest, KernelSurrogate, ModelStore
    from .registry import host_problem, problem_names

    if args.action == "train":
        if not args.store:
            print("error: surrogate train needs --store", file=sys.stderr)
            return 2
        store = SessionStore(args.store)
        mstore = ModelStore(args.models)
        names = ([p for p in args.problem.split(",") if p]
                 if args.problem else problem_names())
        exclude = tuple(a for a in (args.exclude_arch or "").split(",") if a)
        try:
            params = json.loads(args.params)
        except json.JSONDecodeError as e:
            print(f"error: --params is not valid JSON: {e}", file=sys.stderr)
            return 2
        report = []
        for name in names:
            prob = host_problem(name)
            h = Harvest(name, prob.space, exclude_archs=exclude)
            h.add_store(store)
            ts = h.build()
            if len(ts) < args.min_rows:
                report.append({"problem": name, "rows": len(ts),
                               "trained": False})
                continue
            model = KernelSurrogate.fit(ts, params=params)
            path = mstore.save(model)
            report.append({"problem": name, "rows": len(ts),
                           "sources": ts.n_sources,
                           "skipped_estimated": h.n_skipped_estimated,
                           "r2_train": round(model.r2(ts), 4),
                           "trained": True, "path": str(path)})
        if args.json:
            print(json.dumps({"models": args.models, "report": report},
                             separators=(",", ":")))
        else:
            for r in report:
                if r["trained"]:
                    print(f"{r['problem']}: {r['rows']} rows from "
                          f"{r['sources']} source(s) "
                          f"(skipped {r['skipped_estimated']} estimated), "
                          f"train R2 {r['r2_train']:.3f} -> {r['path']}")
                else:
                    print(f"{r['problem']}: {r['rows']} rows "
                          f"(< --min-rows {args.min_rows}), not trained")
        return 0 if any(r["trained"] for r in report) else 1

    if args.action == "predict":
        if not args.problem:
            print("error: surrogate predict needs --problem",
                  file=sys.stderr)
            return 2
        mstore = ModelStore(args.models)
        model, problems = mstore.load(args.problem)
        if model is None:
            for p in problems:
                print(f"error: {p}", file=sys.stderr)
            print(f"error: no usable model for {args.problem!r} in "
                  f"{args.models}", file=sys.stderr)
            return 1
        prob = host_problem(args.problem)
        rows = model.top_rows(prob.space, args.arch, k=args.top)
        preds = model.predict_rows(prob.space, rows, args.arch)
        if args.json:
            print(json.dumps(
                {"problem": args.problem, "arch": args.arch,
                 "rows": rows,
                 "predicted_s": [float(p) for p in preds]},
                separators=(",", ":")))
        else:
            print(f"{args.problem} @ {args.arch}: top {len(rows)} "
                  "predicted rows")
            for row, pred in zip(rows, preds):
                cfg = prob.space.from_flat_index(int(row))
                print(f"  row {row:>10d}  {_fmt_best(float(pred)):>12s}  "
                      f"{json.dumps(cfg, sort_keys=True)}")
        return 0

    # eval: held-out-architecture transfer check
    if not args.store or not args.problem:
        print("error: surrogate eval needs --store and --problem",
              file=sys.stderr)
        return 2
    import numpy as np
    store = SessionStore(args.store)
    prob = host_problem(args.problem)
    h = Harvest(args.problem, prob.space)
    h.add_store(store)
    ts = h.build()
    if args.holdout not in ts.archs:
        print(f"error: --holdout {args.holdout!r} not in arch vocabulary "
              f"{ts.archs}", file=sys.stderr)
        return 2
    rest, held = ts.split_arch(args.holdout)
    if not len(rest) or not len(held):
        print(f"error: empty split (train {len(rest)} rows, "
              f"held-out {len(held)} rows); harvest more sessions",
              file=sys.stderr)
        return 1
    model = KernelSurrogate.fit(rest)
    r2_held = model.r2(held)
    # shuffled-label baseline: same rows, permuted targets — the floor a
    # genuinely transferring model must clear
    from dataclasses import replace
    perm = np.random.default_rng(args.seed).permutation(len(rest))
    baseline = KernelSurrogate.fit(replace(rest, y=rest.y[perm]))
    r2_base = baseline.r2(held)
    top = model.top_params(held)
    out = {"problem": args.problem, "holdout": args.holdout,
           "train_rows": len(rest), "holdout_rows": len(held),
           "r2_holdout": round(float(r2_held), 4),
           "r2_shuffled_baseline": round(float(r2_base), 4),
           "transfers": bool(r2_held > r2_base),
           "top_params": top}
    if args.json:
        print(json.dumps(out, separators=(",", ":")))
    else:
        print(f"{args.problem} held-out {args.holdout}: "
              f"R2 {r2_held:.3f} (shuffled-label baseline {r2_base:.3f}) "
              f"on {len(held)} rows — "
              f"{'transfers' if out['transfers'] else 'DOES NOT transfer'}")
        print(f"  top params: {', '.join(top)}")
    return 0 if out["transfers"] else 1


def _run_lint(args) -> int:
    """``lint`` subcommand body: contract checks (+ space audit)."""
    from pathlib import Path

    from ..staticcheck import (Engine, apply_baseline, default_rules,
                               load_baseline, write_baseline)
    from .doctor import _package_dir
    if args.paths:
        paths = [Path(p) for p in args.paths]
        root = Path.cwd()
    else:
        # default: the installed port package itself, wherever it lives
        pkg = _package_dir()
        paths, root = [pkg], pkg.parent

    engine = Engine(default_rules(), root=root)
    findings = engine.lint_paths(paths)
    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"lint: baseline with {len(findings)} finding(s) "
              f"written to {args.write_baseline}")
        return 0
    if args.baseline:
        findings = apply_baseline(findings, load_baseline(args.baseline))

    audits = []
    if args.spaces:
        from ..staticcheck import audit_space
        from .registry import host_problem, problem_names
        for name in problem_names():
            # a kernel problem defaults to the card; its space is the same
            # on the CPU, so the audit runs on any host
            audits.append(audit_space(host_problem(name).space))

    bad_audits = [a for a in audits if not a.ok]
    if args.json:
        print(json.dumps(
            {"findings": [f.to_json() for f in findings],
             "spaces": [a.to_json() for a in audits],
             "ok": not findings and not bad_audits},
            separators=(",", ":")))
    else:
        for f in findings:
            print(f.render())
        for a in audits:
            print(a.render())
        n = len(findings) + len(bad_audits)
        print(f"lint: {len(findings)} finding(s)"
              + (f", {len(bad_audits)}/{len(audits)} space(s) failing"
                 if audits else "")
              + ("" if n else " — clean"))
    if args.strict and (findings or bad_audits):
        return 1
    return 0


def _start_measuring_early(problems: list[str], archs: list[str],
                           problem_kwargs: dict, mode: str) -> None:
    """Where a session will time a kernel on the card, spawn its measuring
    process before this process imports torch to build the problem
    (``workers.start_early``): each process's start is mostly ``import
    torch``, and the two then run side by side.  Decided from names and,
    for whether the host has a card at all, its NVIDIA device nodes, so
    nothing here imports torch."""
    import glob

    from ..core.costmodel import ARCH_NAMES
    from ..telemetry import trace as trace_mod
    from .registry import PROBLEM_PATHS
    from .workers import start_early
    device = str(problem_kwargs.get("device") or "cuda")
    if (mode == "thread" or not device.startswith("cuda")
            or not glob.glob("/dev/nvidia[0-9]*")
            or not any(p in PROBLEM_PATHS for p in problems)
            or all(a in ARCH_NAMES or a == "cpu" for a in archs)):
        return
    _, _, index = device.partition(":")
    start_early(int(index) if index else None, trace_mod.is_enabled())


def _drain_signals(note: str):
    """Install SIGTERM/SIGINT handlers that set (and return) a stop
    event — first signal drains gracefully, printing ``note``.  No-op
    (still returns the event) off the main thread, where the ``signal``
    module refuses handlers (e.g. CLI funcs driven from test threads)."""
    import signal
    import threading
    stop = threading.Event()

    def _handler(signum, frame):        # pragma: no cover — signal path
        print(note, file=sys.stderr, flush=True)
        stop.set()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
    return stop


def _dispatch(args) -> int:
    if getattr(args, "chaos", None):
        # arm this process's chaos plane before any work touches a seam
        from .chaos import FaultPlan, install
        install(FaultPlan.load(args.chaos))

    if args.cmd == "metrics":
        from pathlib import Path

        from .broker import SQLiteBroker
        if not Path(args.broker).exists():
            # read-only like status: never conjure an empty queue db at
            # a typo'd path and report zero metrics against it
            print(f"error: no broker db at {args.broker!r}",
                  file=sys.stderr)
            return 2
        return _run_metrics(SQLiteBroker(args.broker), raw=args.raw,
                            tail=args.tail, interval=args.interval,
                            count=args.count)

    if args.cmd == "worker":
        from .broker import SQLiteBroker
        from .workers import BrokerWorker
        worker = BrokerWorker(
            SQLiteBroker(args.broker), worker_id=args.id,
            workers=args.workers, mode=args.mode,
            max_retries=args.max_retries, lease_s=args.lease,
            poll_s=args.poll, job_timeout_s=args.job_timeout,
            log=lambda msg: print(msg, file=sys.stderr, flush=True))
        # SIGTERM/ctrl-C = graceful drain: the in-flight job finishes and
        # is completed/failed at the broker before the loop exits
        stop = _drain_signals(
            f"worker {worker.worker_id} draining (finishing in-flight job)")
        print(f"worker {worker.worker_id} serving {args.broker}",
              file=sys.stderr, flush=True)
        served = worker.run(max_jobs=args.max_jobs,
                            max_idle_s=args.max_idle, stop=stop)
        print(f"worker {worker.worker_id} exiting after {served} job(s)",
              file=sys.stderr, flush=True)
        return 0

    if args.cmd == "fleet":
        from .broker import SQLiteBroker
        from .supervisor import FleetSupervisor
        sup = FleetSupervisor(
            SQLiteBroker(args.broker),
            min_workers=args.min_workers, max_workers=args.max_workers,
            eval_workers=args.workers, mode=args.mode, lease_s=args.lease,
            poll_s=args.poll, job_timeout_s=args.job_timeout,
            backoff_base_s=args.backoff,
            crash_loop_threshold=args.crash_loop,
            quarantine_s=args.quarantine,
            scale_down_after_s=args.scale_down_after,
            interval_s=args.interval, chaos_plan=args.chaos,
            log_dir=args.log_dir,
            log=lambda msg: print(msg, file=sys.stderr, flush=True))
        stop = _drain_signals(
            f"fleet {sup.sup_id} draining (workers finish in-flight jobs)")
        print(f"fleet {sup.sup_id} supervising {args.broker} "
              f"({sup.min_workers}..{sup.max_workers} workers)",
              file=sys.stderr, flush=True)
        events = sup.run(stop=stop, max_runtime_s=args.max_runtime,
                         drain_on_empty_s=args.drain_after)
        print(json.dumps(events, separators=(",", ":")))
        return 0

    if args.cmd == "servedb":
        return _run_servedb(args)

    if args.cmd == "surrogate":
        return _run_surrogate(args)

    if args.cmd == "lint":
        return _run_lint(args)

    store = SessionStore(args.store)

    if args.cmd == "doctor":
        from .doctor import diagnose, render_report
        broker = None
        if args.broker is not None:
            from pathlib import Path

            from .broker import SQLiteBroker
            if not Path(args.broker).exists():
                # doctor is read-only: never conjure an empty queue db at
                # a typo'd path and declare it healthy
                print(f"error: no broker db at {args.broker!r}",
                      file=sys.stderr)
                return 2
            broker = SQLiteBroker(args.broker)
        report = diagnose(store, broker, servedb=args.servedb,
                          lint=args.lint)
        if args.json:
            print(json.dumps(report, separators=(",", ":")))
        else:
            print(render_report(report))
        return 0 if report["ok"] else 1

    if args.cmd == "status":
        broker = None
        if args.broker is not None:
            from pathlib import Path

            from .broker import SQLiteBroker
            if not Path(args.broker).exists():
                # status is read-only: never conjure an empty queue db at
                # a typo'd path and report "no leases" against it
                print(f"error: no broker db at {args.broker!r}",
                      file=sys.stderr)
                return 2
            broker = SQLiteBroker(args.broker)
        return _print_status(store, args.session, broker,
                             as_json=args.json, watch=args.watch,
                             interval=args.interval, count=args.count)

    if args.cmd == "submit":
        if args.problem not in problem_names():
            print(f"error: unknown problem {args.problem!r}; "
                  f"registered: {', '.join(problem_names())}", file=sys.stderr)
            return 2
        from ..core.tuners import TUNERS
        if args.tuner not in TUNERS:
            print(f"error: unknown tuner {args.tuner!r}; "
                  f"registered: {', '.join(sorted(TUNERS))}", file=sys.stderr)
            return 2
        try:
            tuner_kwargs = json.loads(args.tuner_kwargs)
            problem_kwargs = _problem_kwargs(args)
        except json.JSONDecodeError as e:
            print(f"error: --tuner-kwargs/--problem-kwargs is not valid "
                  f"JSON: {e}", file=sys.stderr)
            return 2
        model = None
        if args.warm_start:
            from ..core.surrogate import ModelStore
            model, problems = ModelStore(args.warm_start).load(args.problem)
            if model is None:
                for p in problems:
                    print(f"error: {p}", file=sys.stderr)
                print(f"error: --warm-start: no usable model for "
                      f"{args.problem!r} in {args.warm_start}",
                      file=sys.stderr)
                return 2
        _start_measuring_early([args.problem], [args.arch], problem_kwargs,
                               args.mode)
        warm_rows = None
        if model is not None:
            from .registry import host_problem
            space = host_problem(args.problem, **problem_kwargs).space
            warm_rows = model.top_rows(space, args.arch, k=args.warm_top)
            print(f"warm start: {len(warm_rows)} predicted-top rows "
                  f"for {args.arch}")
        spec = SessionSpec(problem=args.problem, tuner=args.tuner,
                           arch=args.arch, budget=args.budget, seed=args.seed,
                           workers=args.workers, tuner_kwargs=tuner_kwargs,
                           problem_kwargs=problem_kwargs,
                           warm_start=warm_rows)
        sid = store.create(spec)
        print(f"session {sid}")
        res = run_session(spec, store=store, mode=args.mode,
                          max_retries=args.max_retries,
                          stop_after=args.stop_after)
        b = res.best
        print(f"{len(res.trials)} trials; best {_fmt_best(b.objective)} "
              f"config={b.config if b.ok else None}")
        return 0

    if args.cmd == "campaign":
        from ..core.tuners import TUNERS
        from .campaign import Campaign
        problems = [p for p in args.problems.split(",") if p]
        tuners = [t for t in args.tuners.split(",") if t]
        archs = [a for a in args.archs.split(",") if a]
        bad = [p for p in problems if p not in problem_names()]
        if bad:
            print(f"error: unknown problem(s) {', '.join(bad)}; "
                  f"registered: {', '.join(problem_names())}", file=sys.stderr)
            return 2
        bad = [t for t in tuners if t not in TUNERS]
        if bad:
            print(f"error: unknown tuner(s) {', '.join(bad)}; "
                  f"registered: {', '.join(sorted(TUNERS))}", file=sys.stderr)
            return 2
        try:
            seeds = [int(s) for s in args.seeds.split(",") if s]
            tuner_kwargs = _parse_tuner_args(args.tuner_arg,
                                             json.loads(args.tuner_kwargs))
            problem_kwargs = _problem_kwargs(args)
        except (ValueError, json.JSONDecodeError) as e:
            print(f"error: bad --seeds/--tuner-kwargs/--tuner-arg/"
                  f"--problem-kwargs: {e}", file=sys.stderr)
            return 2
        broker = None
        if args.broker is not None:
            if args.serial:
                print("error: --broker implies interleaving "
                      "(drop --serial)", file=sys.stderr)
                return 2
            from .broker import SQLiteBroker
            broker = SQLiteBroker(args.broker)
        else:
            _start_measuring_early(problems, archs, problem_kwargs,
                                   args.mode)
        camp = Campaign.grid(problems=problems, tuners=tuners, archs=archs,
                             seeds=seeds, budget=args.budget,
                             workers=args.workers, tuner_kwargs=tuner_kwargs,
                             problem_kwargs=problem_kwargs)
        print(f"campaign: {len(camp)} sessions "
              f"({len(problems)} problems x {len(tuners)} tuners x "
              f"{len(archs)} archs x {len(seeds)} seeds)"
              + (f" via broker {args.broker}" if broker else ""))
        camp.run(store, workers=args.workers, mode=args.mode,
                 max_retries=args.max_retries,
                 interleave=not args.serial,
                 share_archs=not args.no_share_archs, broker=broker)
        return _print_status(store, None, broker)

    if args.cmd == "resume":
        if not store.exists(args.session):
            print(f"error: no session {args.session!r} in {store.root}",
                  file=sys.stderr)
            return 2
        spec = store.load_spec(args.session)
        _start_measuring_early([spec.problem], [spec.arch],
                               spec.problem_kwargs, "auto")
        res = resume_session(args.session, store, workers=args.workers)
        b = res.best
        print(f"session {args.session}: {len(res.trials)} trials; "
              f"best {_fmt_best(b.objective)}")
        return 0

    return 2  # pragma: no cover — argparse enforces the subcommand


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
