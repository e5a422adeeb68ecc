"""The find-DB snapshot: grammar, checksums, atomic publish, quarantine.

A snapshot is the serving layer's unit of truth — one JSON document,
``servedb.json``, inside a find-DB directory, optionally accompanied by a
binary table export (``tables-g<generation>.npz``).  Its robustness
contract (docs/architecture.md, "Serving contracts"):

* **Atomic publish.**  ``publish`` writes a temp file, fsyncs it, then
  ``os.replace``-renames it over the live name (and fsyncs the
  directory).  A crash or SIGKILL at *any* instant leaves either the old
  snapshot or the new one visible — never a torn hybrid.  The window
  between temp-write and rename is an armed chaos site
  (``servedb.publish.crash``) so that exact claim is drilled, not
  assumed.
* **Tamper evidence.**  The header records a sha256 over the canonical
  JSON of every section (and over the binary export's bytes), so a
  snapshot corrupted *after* publish — torn sector, bit rot, a truncated
  copy — is detected on load, never half-served.  The post-publish
  corruption is itself a chaos site (``servedb.snapshot.corrupt``).
* **Quarantine, don't crash.**  ``load`` answers ``(snapshot | None,
  problems)``; a corrupt file is moved into ``quarantine/`` (counted in
  telemetry, triaged by ``doctor --servedb``) and the caller keeps serving
  whatever it last loaded.  Nothing in this module raises on corrupt
  *input*; only programming errors and publish-side failures do.

Snapshot grammar (version 1)::

    {"header": {"magic": "repro-servedb", "version": 1,
                "generation": 3, "created_at": <epoch s>,
                "ttl_s": 86400.0 | null, "source": "<store path>",
                "binary": "tables-g3.npz" | null,
                "sections": {"tables": "<sha256>",
                             "binary": "<sha256>" | null}},
     "tables": {<kernel>: {<arch>: {
         "param_names": [...],
         "heuristic": {config} | null,
         "entries": [{"shape": {dim: int, ...}, "config": {...},
                      "objective": seconds, "protocol": "session_...",
                      "trials": n}, ...]}}}}

Entries are sorted by canonical shape key, kernels and archs
alphabetically — the document is byte-deterministic for a given input,
so "unchanged snapshot republished" is detectable by file bytes alone.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..core.retry import retry_call
from ..orchestrator import chaos
from ..telemetry import metrics as _metrics

__all__ = ["MAGIC", "VERSION", "SNAPSHOT_NAME", "Snapshot", "SnapshotError",
           "shape_key", "shape_distance", "section_checksum",
           "publish", "load", "quarantine", "verify_dir"]

MAGIC = "repro-servedb"
VERSION = 1
SNAPSHOT_NAME = "servedb.json"
QUARANTINE_DIR = "quarantine"
LOCK_NAME = "publish.lock"
#: a publish lock older than this is from a dead publisher — break it
LOCK_STALE_S = 60.0


class SnapshotError(Exception):
    """A snapshot failed validation (bad magic/version/checksum).  Raised
    by :func:`parse`; :func:`load` converts it into quarantine + None."""


# --------------------------------------------------------------------- #
# shape keys and distances
# --------------------------------------------------------------------- #
def shape_key(shape: dict) -> str:
    """Canonical identity of a problem shape: sorted compact JSON."""
    return json.dumps(shape or {}, sort_keys=True, separators=(",", ":"))


def shape_distance(a: dict, b: dict) -> float:
    """Nearest-shape metric: L2 in log2 space over the union of dims.

    Tuned block sizes track *ratios* of problem dimensions, so a 4096 vs
    8192 sequence (1 apart in log2) is nearer than 4096 vs 65536 even
    though the linear gaps say otherwise.  A dim present on one side
    only, or non-numeric / non-positive on either, costs a fixed
    ``missing`` penalty — shapes over different dims are far apart but
    still *ordered*, which the deterministic fallback chain requires.
    """
    import math
    a, b = a or {}, b or {}
    missing = 32.0
    tot = 0.0
    for k in set(a) | set(b):
        va, vb = a.get(k), b.get(k)
        if isinstance(va, bool) or isinstance(vb, bool) \
                or not isinstance(va, (int, float)) \
                or not isinstance(vb, (int, float)) \
                or va <= 0 or vb <= 0:
            tot += missing ** 2
        else:
            tot += (math.log2(va) - math.log2(vb)) ** 2
    return math.sqrt(tot)


# --------------------------------------------------------------------- #
# the document
# --------------------------------------------------------------------- #
def section_checksum(obj) -> str:
    """sha256 over the canonical JSON of one section."""
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def _canonical_tables(tables: dict) -> dict:
    """Kernels/archs sorted, entries sorted by shape key: the
    byte-deterministic form every publish writes and checksums."""
    out: dict = {}
    for kernel in sorted(tables):
        out[kernel] = {}
        for arch in sorted(tables[kernel]):
            g = tables[kernel][arch]
            out[kernel][arch] = {
                "param_names": list(g.get("param_names", [])),
                "heuristic": g.get("heuristic"),
                "entries": sorted(g.get("entries", []),
                                  key=lambda e: shape_key(e.get("shape"))),
            }
    return out


@dataclass
class Snapshot:
    """One parsed (or about-to-be-published) find-DB snapshot."""

    tables: dict = field(default_factory=dict)
    generation: int = 0
    created_at: float = 0.0
    ttl_s: float | None = None
    source: str = ""
    binary: str | None = None        # npz filename, relative to the dir
    binary_sha: str | None = None

    # -- queries --------------------------------------------------------- #
    def group(self, kernel: str, arch: str) -> dict | None:
        return self.tables.get(kernel, {}).get(arch)

    def kernels(self) -> list[str]:
        return sorted(self.tables)

    def n_entries(self) -> int:
        return sum(len(g.get("entries", []))
                   for k in self.tables.values() for g in k.values())

    def age_s(self, now: float | None = None) -> float:
        return (time.time() if now is None else now) - self.created_at

    def stale(self, ttl_s: float | None = None,
              now: float | None = None) -> bool:
        """Past its TTL?  An explicit ``ttl_s`` overrides the header's;
        no TTL anywhere means a snapshot never goes stale."""
        ttl = self.ttl_s if ttl_s is None else ttl_s
        return ttl is not None and self.age_s(now) > ttl

    # -- (de)serialization ----------------------------------------------- #
    def to_json(self) -> dict:
        tables = _canonical_tables(self.tables)
        return {
            "header": {
                "magic": MAGIC, "version": VERSION,
                "generation": int(self.generation),
                "created_at": float(self.created_at),
                "ttl_s": self.ttl_s, "source": self.source,
                "binary": self.binary,
                "sections": {"tables": section_checksum(tables),
                             "binary": self.binary_sha},
            },
            "tables": tables,
        }

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":")).encode()


def parse(raw: bytes) -> Snapshot:
    """Validate and parse snapshot bytes; raises :class:`SnapshotError`
    on any corruption (bad JSON, wrong magic/version, checksum
    mismatch)."""
    try:
        doc = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise SnapshotError(f"not valid JSON ({e})") from e
    if not isinstance(doc, dict) or "header" not in doc:
        raise SnapshotError("no header")
    h = doc["header"]
    if h.get("magic") != MAGIC:
        raise SnapshotError(f"bad magic {h.get('magic')!r}")
    if h.get("version") != VERSION:
        raise SnapshotError(f"unsupported version {h.get('version')!r}")
    want = h.get("sections", {}).get("tables")
    got = section_checksum(doc.get("tables", {}))
    if want != got:
        raise SnapshotError(
            f"tables checksum mismatch (header {str(want)[:12]}…, "
            f"content {got[:12]}…)")
    return Snapshot(
        tables=doc.get("tables", {}),
        generation=int(h.get("generation", 0)),
        created_at=float(h.get("created_at", 0.0)),
        ttl_s=h.get("ttl_s"), source=h.get("source", ""),
        binary=h.get("binary"),
        binary_sha=h.get("sections", {}).get("binary"))


# --------------------------------------------------------------------- #
# atomic publish
# --------------------------------------------------------------------- #
def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                 # platforms without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path: Path, data: bytes, crash_site: str | None) -> None:
    """temp-write -> fsync -> [chaos crash window] -> rename -> dir fsync."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if crash_site is not None:
        # the exact window a SIGKILL would hit between temp and commit:
        # the temp file is durable, the live name still points at the old
        # snapshot (or nothing) — readers must never see a torn document
        chaos.crash(crash_site)
    os.replace(tmp, path)
    _fsync_dir(path.parent)


def _corrupt_in_place(path: Path, params: dict) -> None:
    """The ``servedb.snapshot.corrupt`` site body: truncate or bit-flip
    the published file, the artifact a dying disk leaves behind."""
    data = path.read_bytes()
    if not data:
        return
    frac = min(max(float(params.get("frac", 0.5)), 0.0), 1.0)
    at = min(max(int(len(data) * frac), 0), len(data) - 1)
    if params.get("mode", "truncate") == "bitflip":
        corrupted = bytes([*data[:at], data[at] ^ 0x20, *data[at + 1:]])
    else:
        corrupted = data[:max(at, 1)]
    path.write_bytes(corrupted)


class _PublishLock:
    """O_CREAT|O_EXCL lock file, acquired with the shared bounded-backoff
    policy (the same code path the SQLite broker retries through) so two
    concurrent publishers serialize instead of racing the rename.  Locks
    older than :data:`LOCK_STALE_S` belong to dead publishers and are
    broken."""

    def __init__(self, root: Path, retries: int = 40):
        self.path = root / LOCK_NAME
        self.retries = retries
        self._fd: int | None = None

    def _holder_dead(self) -> bool:
        """Is the current lock abandoned?  Age past :data:`LOCK_STALE_S`
        always counts; a same-host holder whose pid no longer exists
        counts immediately (a SIGKILLed publisher must not stall the next
        publish for a minute)."""
        try:
            st = self.path.stat()
        except OSError:
            return False
        if time.time() - st.st_mtime > LOCK_STALE_S:
            return True
        try:
            pid = int(self.path.read_text().strip() or "0")
            if pid > 0:
                os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except (OSError, ValueError):
            pass
        return False

    def _try_acquire(self) -> None:
        if self._holder_dead():
            self.path.unlink(missing_ok=True)
        self._fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.write(self._fd, f"{os.getpid()}\n".encode())

    def __enter__(self) -> "_PublishLock":
        retry_call(self._try_acquire, retries=self.retries,
                   retry_on=lambda e: isinstance(e, FileExistsError),
                   base_s=0.01, max_s=0.25, salt=str(self.path),
                   what=f"servedb publish lock {self.path}")
        return self

    def __exit__(self, *exc) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        self.path.unlink(missing_ok=True)


def publish(snapshot: Snapshot, root: str | Path,
            binary_bytes: bytes | None = None) -> Path:
    """Atomically publish ``snapshot`` (and optionally its binary export)
    into find-DB directory ``root``; returns the snapshot path.

    Generation is assigned here — one past whatever the live snapshot
    (valid or not) claims — and ``created_at`` is stamped if unset.  The
    publisher may fail loudly (it is an offline build step); *readers*
    never do.
    """
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    snap_path = root / SNAPSHOT_NAME
    with _PublishLock(root):
        snapshot.generation = _live_generation(snap_path) + 1
        if not snapshot.created_at:
            snapshot.created_at = time.time()
        if binary_bytes is not None:
            snapshot.binary = f"tables-g{snapshot.generation}.npz"
            snapshot.binary_sha = hashlib.sha256(binary_bytes).hexdigest()
            # the npz commits first so the JSON header never names a
            # binary that is not yet durable
            _write_atomic(root / snapshot.binary, binary_bytes,
                          crash_site=None)
        else:
            snapshot.binary = snapshot.binary_sha = None
        _write_atomic(snap_path, snapshot.to_bytes(),
                      crash_site=chaos.SERVEDB_PUBLISH_CRASH)
        params = chaos.fire(chaos.SERVEDB_SNAPSHOT_CORRUPT)
        if params is not None:
            _corrupt_in_place(snap_path, params)
        _gc_binaries(root, keep=snapshot.binary)
    _metrics.counter("servedb.publish").inc()
    return snap_path


def _live_generation(snap_path: Path) -> int:
    """Best-effort generation of whatever sits at the live name — header
    only, no checksum (a corrupt gen-5 snapshot must still be succeeded
    by gen 6, not a second gen 1)."""
    try:
        doc = json.loads(snap_path.read_bytes())
        return int(doc["header"]["generation"])
    except Exception:
        return 0


def _gc_binaries(root: Path, keep: str | None) -> None:
    """Drop binary exports of superseded generations (readers of the old
    JSON have it in memory; nothing re-opens an old npz by name)."""
    for p in root.glob("tables-g*.npz"):
        if p.name != keep:
            p.unlink(missing_ok=True)


# --------------------------------------------------------------------- #
# load + quarantine
# --------------------------------------------------------------------- #
def quarantine(path: Path, reason: str) -> Path | None:
    """Move a corrupt snapshot aside (``quarantine/<name>.<n>.bad``) so it
    is never parsed again but stays available for triage.  Returns the
    quarantined path, or None when the move itself failed (read-only
    filesystem — the caller still refuses to serve the file)."""
    qdir = path.parent / QUARANTINE_DIR
    try:
        qdir.mkdir(exist_ok=True)
        n = 0
        while (dst := qdir / f"{path.name}.{n}.bad").exists():
            n += 1
        os.replace(path, dst)
        (dst.with_suffix(dst.suffix + ".reason")).write_text(reason + "\n")
    except OSError:
        return None
    _metrics.counter("servedb.quarantined").inc()
    return dst


def load(root: str | Path, *, do_quarantine: bool = True
         ) -> tuple[Snapshot | None, list[str]]:
    """Read the live snapshot under ``root``.

    Returns ``(snapshot, problems)`` and **never raises**: a missing file
    is ``(None, [])``; a corrupt one is quarantined (when
    ``do_quarantine``), reported in ``problems``, and returns ``None`` so
    the caller keeps serving its previous snapshot or degrades.  A
    binary-export checksum mismatch quarantines only the npz — the JSON
    tables are intact and keep serving.
    """
    root = Path(root)
    path = root / SNAPSHOT_NAME
    problems: list[str] = []
    try:
        raw = path.read_bytes()
    except FileNotFoundError:
        return None, problems
    except OSError as e:
        return None, [f"{path}: unreadable ({e})"]
    try:
        snap = parse(raw)
    except SnapshotError as e:
        msg = f"{path}: corrupt snapshot ({e})"
        if do_quarantine:
            dst = quarantine(path, str(e))
            msg += f"; quarantined to {dst}" if dst \
                else "; quarantine failed (file left in place, not served)"
        problems.append(msg)
        return None, problems
    if snap.binary is not None:
        bpath = root / snap.binary
        try:
            sha = hashlib.sha256(bpath.read_bytes()).hexdigest()
            ok = sha == snap.binary_sha
        except OSError:
            ok = False
        if not ok:
            problems.append(
                f"{bpath}: binary export missing or checksum mismatch "
                f"(JSON tables intact; binary disabled)")
            if do_quarantine and bpath.exists():
                quarantine(bpath, "binary checksum mismatch")
            snap.binary = snap.binary_sha = None
    _metrics.counter("servedb.load").inc()
    return snap, problems


# --------------------------------------------------------------------- #
# offline triage (doctor --servedb / servedb verify)
# --------------------------------------------------------------------- #
def verify_dir(root: str | Path) -> dict:
    """Read-only health report of a find-DB directory — what ``doctor
    --servedb`` and ``servedb verify`` render.  Never quarantines,
    never mutates; one verdict line per snapshot artifact."""
    root = Path(root)
    report: dict = {"root": str(root), "snapshots": [], "quarantined": [],
                    "leftover_tmp": [], "problems": [], "ok": True}
    path = root / SNAPSHOT_NAME
    if not root.exists():
        report["problems"].append(f"{root}: no such find-DB directory")
    elif not path.exists():
        report["problems"].append(
            f"{root}: no {SNAPSHOT_NAME} (never built, or a publish "
            f"crashed before its first rename)")
    else:
        entry = {"file": path.name}
        try:
            snap = parse(path.read_bytes())
            entry.update(
                status="ok", generation=snap.generation,
                created_at=snap.created_at, kernels=len(snap.tables),
                entries=snap.n_entries(), stale=snap.stale(),
                binary=snap.binary)
            if snap.stale():
                entry["status"] = "stale"
                report["problems"].append(
                    f"{path.name}: past its ttl ({snap.ttl_s:.0f}s) — "
                    f"rebuild from a fresher campaign")
            if snap.binary is not None:
                bpath = root / snap.binary
                try:
                    bsha = hashlib.sha256(bpath.read_bytes()).hexdigest()
                    bok = bsha == snap.binary_sha
                except OSError:
                    bok = False
                entry["binary_ok"] = bok
                if not bok:
                    report["problems"].append(
                        f"{snap.binary}: binary export missing or "
                        f"checksum-failing (JSON tables still serve)")
        except SnapshotError as e:
            entry.update(status="corrupt", error=str(e))
            report["problems"].append(
                f"{path.name}: corrupt ({e}) — will be quarantined on "
                f"next load; lookups degrade to heuristic/default tiers")
        report["snapshots"].append(entry)
    qdir = root / QUARANTINE_DIR
    if qdir.exists():
        for p in sorted(qdir.iterdir()):
            if p.suffix == ".reason":
                continue
            reason_p = p.with_suffix(p.suffix + ".reason")
            reason = reason_p.read_text().strip() \
                if reason_p.exists() else "?"
            report["quarantined"].append({"file": p.name, "reason": reason})
        if report["quarantined"]:
            report["problems"].append(
                f"{len(report['quarantined'])} quarantined snapshot(s) "
                f"under {qdir} (corruption history; delete after triage)")
    if root.exists():
        for p in sorted(root.glob("*.tmp")):
            report["leftover_tmp"].append(p.name)
            report["problems"].append(
                f"{p.name}: leftover temp file (a publish crashed between "
                f"temp-write and rename; safe to delete — the live "
                f"snapshot was never touched)")
    report["ok"] = not report["problems"]
    return report
