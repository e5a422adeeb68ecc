"""On-disk model store: versioned, checksummed, quarantine-on-corrupt.

Mirrors the servedb snapshot conventions (``servedb/snapshot.py``):
one canonical-JSON file per kernel with a versioned header and a sha256
section checksum, atomic temp-write + fsync + rename publication, corrupt
files quarantined (never deleted, never served) and :meth:`ModelStore.load`
returning ``(model | None, problems)`` instead of raising — a missing or
damaged model must degrade a warm start to a cold start, not crash a
session.

Header grammar (the ``model-store-keys`` lint rule holds header literals
to this vocabulary)::

    {"header": {"magic": "repro-models", "version": 1,
                "problem": <kernel>, "created_at": <epoch seconds>,
                "feature_names": [...], "archs": [...],
                "params": {...gbdt hyperparameters...},
                "n_rows": <training rows>,
                "sections": {"model": "sha256:<hex>"}},
     "model": {...tree tables...}}
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

from ...telemetry import metrics as _metrics
from .model import KernelSurrogate

MAGIC = "repro-models"
VERSION = 1
QUARANTINE_DIR = "quarantine"

#: the documented header vocabulary — source of truth for the
#: ``model-store-keys`` staticcheck rule and the architecture.md grammar
HEADER_FIELDS = ("magic", "version", "problem", "created_at",
                 "feature_names", "archs", "params", "n_rows", "sections")


class ModelStoreError(Exception):
    """A model file failed validation (bad magic/version/checksum/shape)."""


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def section_checksum(obj) -> str:
    return "sha256:" + hashlib.sha256(_canonical(obj)).hexdigest()


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(dirfd)                # the rename itself must be durable
    finally:
        os.close(dirfd)


def parse_model(raw: bytes) -> KernelSurrogate:
    """Strict parse: raises :class:`ModelStoreError` on any defect."""
    try:
        doc = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ModelStoreError(f"not JSON: {e}") from e
    if not isinstance(doc, dict) or "header" not in doc:
        raise ModelStoreError("missing header")
    header = doc["header"]
    if header.get("magic") != MAGIC:
        raise ModelStoreError(f"bad magic {header.get('magic')!r}")
    if header.get("version") != VERSION:
        raise ModelStoreError(f"unsupported version {header.get('version')!r}")
    unknown = sorted(set(header) - set(HEADER_FIELDS))
    if unknown:
        raise ModelStoreError(f"undocumented header field(s): {unknown}")
    sections = header.get("sections", {})
    if "model" not in doc or "model" not in sections:
        raise ModelStoreError("missing model section")
    want = sections["model"]
    got = section_checksum(doc["model"])
    if want != got:
        raise ModelStoreError(f"model checksum mismatch: header says "
                              f"{want}, payload hashes to {got}")
    try:
        return KernelSurrogate.from_parts(
            problem=header["problem"],
            param_names=header["feature_names"][:-1],
            archs=header["archs"], params=dict(header.get("params", {})),
            n_rows=header.get("n_rows", 0), payload=doc["model"])
    except (KeyError, TypeError, ValueError, IndexError) as e:
        raise ModelStoreError(f"malformed model payload: {e}") from e


class ModelStore:
    """Directory of per-kernel surrogate models.

    ``clock`` only stamps the operator-facing ``created_at`` header field
    (injectable, like the session store's) — it never influences model
    bytes beyond that field.
    """

    def __init__(self, root: str | Path, *, clock=time.time):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._clock = clock

    def path(self, problem: str) -> Path:
        return self.root / f"{problem}.model.json"

    def list_models(self) -> list[str]:
        return sorted(p.name[:-len(".model.json")]
                      for p in self.root.glob("*.model.json"))

    # -- write -------------------------------------------------------------- #
    def save(self, model: KernelSurrogate) -> Path:
        payload = model.payload()
        header = {
            "magic": MAGIC, "version": VERSION,
            "problem": model.problem,
            "created_at": float(self._clock()),
            "feature_names": list(model.feature_names),
            "archs": list(model.archs),
            "params": model.params,
            "n_rows": int(model.n_rows),
            "sections": {"model": section_checksum(payload)},
        }
        path = self.path(model.problem)
        _write_atomic(path, _canonical({"header": header, "model": payload}))
        return path

    # -- read (never raises) ------------------------------------------------- #
    def quarantine(self, path: Path, reason: str) -> Path:
        """Move a corrupt file aside (numbered, with a ``.reason`` note) so
        it is preserved for forensics but never parsed again."""
        qdir = self.root / QUARANTINE_DIR
        qdir.mkdir(exist_ok=True)
        n = 0
        while (dest := qdir / f"{path.name}.{n}.bad").exists():
            n += 1
        os.replace(path, dest)
        dest.with_suffix(dest.suffix + ".reason").write_text(reason + "\n")
        _metrics.counter("surrogate.quarantined").inc()
        return dest

    def load(self, problem: str) -> tuple[KernelSurrogate | None, list[str]]:
        """Parse one kernel's model; ``(None, problems)`` on any defect —
        the corrupt file is quarantined, the caller degrades gracefully."""
        path = self.path(problem)
        if not path.exists():
            return None, [f"no model for {problem!r} in {self.root}"]
        try:
            raw = path.read_bytes()
        except OSError as e:
            return None, [f"unreadable {path.name}: {e}"]
        try:
            return parse_model(raw), []
        except ModelStoreError as e:
            self.quarantine(path, str(e))
            return None, [f"quarantined {path.name}: {e}"]

    def verify_dir(self) -> dict:
        """Read-only triage of every model file (no quarantining):
        ``{"ok": [problems...], "problems": {filename: defect}}``."""
        ok, bad = [], {}
        for name in self.list_models():
            try:
                parse_model(self.path(name).read_bytes())
                ok.append(name)
            except (ModelStoreError, OSError) as e:
                bad[self.path(name).name] = str(e)
        return {"ok": ok, "problems": bad}
