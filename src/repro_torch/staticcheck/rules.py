"""The repo-specific lint rules ``repro_torch.orchestrator lint`` enforces.

Each rule guards a contract documented in ``docs/architecture.md``
("Checked contracts"); the docstrings here are the canonical one-line
statements of those contracts.  The rules are the JAX package's, with one
difference: the port's worker pool emits a span the JAX package's does not
(``pool.retry``), so :data:`DOCUMENTED_SPANS` here names it too.  Rules are deliberately narrow: they
flag the patterns that have bitten (or would bite) *this* codebase, not
generic style — that is ruff's job (see ``[tool.ruff]`` in
``pyproject.toml``).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..core.surrogate.store import HEADER_FIELDS
from .engine import FileContext, Finding, Rule

__all__ = ["default_rules", "DETERMINISTIC_PATHS", "DOCUMENTED_SPANS",
           "DOCUMENTED_METRICS", "MODEL_HEADER_FIELDS"]


#: path prefixes forming the determinism seam: replayed journals, seeded
#: tuner streams and lease bookkeeping all flow through these — wall
#: clocks and global RNG state here break bit-identical resume.
DETERMINISTIC_PATHS = (
    "core/tuners/",
    "core/spacetable.py",
    "core/space.py",
    "orchestrator/runner.py",
    "orchestrator/session.py",
    "orchestrator/store.py",
    "orchestrator/campaign.py",
    "orchestrator/broker.py",
    "orchestrator/workers.py",
)

#: span name -> category, as documented in the architecture.md span
#: table, plus ``pool.retry``: the port's ``WorkerPool`` wraps a retried
#: chunk in it (``orchestrator/workers.py``; the README's port section
#: documents it).  ``span(name, cat=...)`` calls with literal names must
#: match.
DOCUMENTED_SPANS = {
    "session.ask": "session", "session.tell": "session",
    "tuner.ask": "tuner", "tuner.tell": "tuner",
    "pool.evaluate": "pool", "pool.chunk": "pool", "pool.retry": "pool",
    "journal.append": "store", "journal.publish": "store",
    "broker.submit": "broker", "broker.lease": "broker",
    "broker.heartbeat": "broker", "broker.complete": "broker",
    "broker.fail": "broker", "broker.collect": "broker",
    "worker.job": "worker",
    "campaign.round": "campaign",
    "eval.features": "eval", "eval.estimate": "eval",
    "kernel.build": "kernel", "kernel.measure": "kernel",
}

#: metric names documented in the architecture.md metric table.
DOCUMENTED_METRICS = frozenset({
    "session.evals", "session.cache_hits", "session.best",
    "session.evals_to_best",
    "space_cache.hit", "space_cache.miss",
    "journal.torn_lines",
    "servedb.lookup", "servedb.lookup_stale", "servedb.reload",
    "servedb.publish", "servedb.quarantined", "servedb.load",
    "session.screened", "surrogate.quarantined",
})

#: the surrogate model file's header fields: the model store's own
#: grammar (``core/surrogate/store.py`` ``HEADER_FIELDS``)
MODEL_HEADER_FIELDS = HEADER_FIELDS

#: the ``layer.verb`` grammar every telemetry name must fit
_NAME_GRAMMAR = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")


def _in_deterministic_seam(path: str) -> bool:
    norm = path.replace("\\", "/")
    for prefix in DETERMINISTIC_PATHS:
        if f"/{prefix}" in f"/{norm}" or norm.startswith(prefix):
            return True
    return False


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class WallClockRule(Rule):
    """No ``time.time()`` calls in deterministic seams.

    Wall time in the journal/tuner/lease path makes a resumed run
    diverge from the uninterrupted one.  Modules on the seam take an
    injected ``clock`` (wall for persisted epochs, ``time.monotonic``
    for durations); referencing ``time.time`` as a *default* for such a
    parameter is fine — calling it inline is not.
    """

    id = "wall-clock"
    description = "time.time() called in a deterministic seam"

    def applies(self, path: str) -> bool:
        return _in_deterministic_seam(path)

    def check(self, node: ast.AST, ctx: FileContext) -> Iterator[Finding]:
        if isinstance(node, ast.Call) and _dotted(node.func) == "time.time":
            yield self.finding(
                ctx, node,
                "time.time() in a deterministic seam; take an injected "
                "clock (see SessionStore/Broker) instead")


class GlobalRngRule(Rule):
    """No module-level RNG state in deterministic seams.

    ``random.random()`` / ``np.random.rand()`` draw from process-global
    state any import can perturb; seeded replay requires instance RNGs
    (``random.Random(seed)``, ``np.random.default_rng(seed)``) or keyed
    ``jax.random``.
    """

    id = "global-rng"
    description = "module-global RNG state used in a deterministic seam"

    _RANDOM_OK = frozenset({"Random", "SystemRandom", "getstate"})
    _NP_OK = frozenset({"default_rng", "Generator", "RandomState"})

    def applies(self, path: str) -> bool:
        return _in_deterministic_seam(path)

    def check(self, node: ast.AST, ctx: FileContext) -> Iterator[Finding]:
        if not isinstance(node, ast.Call):
            return
        name = _dotted(node.func)
        if name is None or "." not in name:
            return
        head, _, tail = name.rpartition(".")
        if head == "random" and tail not in self._RANDOM_OK:
            yield self.finding(
                ctx, node,
                f"global RNG call {name}(); use an instance "
                "random.Random(seed) instead")
        elif head in ("np.random", "numpy.random") and tail not in self._NP_OK:
            yield self.finding(
                ctx, node,
                f"global RNG call {name}(); use "
                "np.random.default_rng(seed) instead")


class ChaosSiteRule(Rule):
    """Chaos hooks must name registered sites.

    A typo'd site string silently never fires; every literal first
    argument to ``chaos.fire/sleep/skew/die/crash`` must be a member of
    ``chaos.SITES`` (prefer the importable constants).
    """

    id = "chaos-site"
    description = "chaos hook called with an unregistered site literal"

    _HOOKS = frozenset({"fire", "sleep", "skew", "die", "crash"})

    def check(self, node: ast.AST, ctx: FileContext) -> Iterator[Finding]:
        if not (isinstance(node, ast.Call) and node.args):
            return
        name = _dotted(node.func)
        if name is None:
            return
        head, _, tail = name.rpartition(".")
        if not head.endswith("chaos") or tail not in self._HOOKS:
            return
        site = _str_const(node.args[0])
        if site is None:
            return
        from ..orchestrator.chaos import SITES
        if site not in SITES:
            yield self.finding(
                ctx, node,
                f"chaos site {site!r} is not in chaos.SITES; use the "
                "importable constants in repro_torch.orchestrator.chaos")


class TelemetryNameRule(Rule):
    """Span and metric names must match the documented grammar.

    Literal names passed to ``span(...)`` must appear in the
    architecture.md span table with the matching ``cat``; literal names
    passed to ``metrics.counter/gauge/histogram`` must appear in the
    metric table.  Undocumented names fragment dashboards silently.
    """

    id = "telemetry-name"
    description = "span/metric name not in the documented telemetry tables"

    _METRIC_KINDS = frozenset({"counter", "gauge", "histogram"})

    def applies(self, path: str) -> bool:
        # the telemetry package itself defines the primitives
        return "telemetry/" not in path.replace("\\", "/")

    def check(self, node: ast.AST, ctx: FileContext) -> Iterator[Finding]:
        if not (isinstance(node, ast.Call) and node.args):
            return
        name = _dotted(node.func)
        if name is None:
            return
        head, _, tail = name.rpartition(".")
        literal = _str_const(node.args[0])
        if tail == "span" and head in ("", "trace"):
            if literal is None:
                return
            if literal not in DOCUMENTED_SPANS:
                hint = ("does not fit the layer.verb grammar"
                        if not _NAME_GRAMMAR.match(literal)
                        else "is not in the documented span table")
                yield self.finding(
                    ctx, node,
                    f"span name {literal!r} {hint} "
                    "(docs/architecture.md: Telemetry contracts)")
                return
            cat = self._kw(node, "cat")
            if cat is not None and cat != DOCUMENTED_SPANS[literal]:
                yield self.finding(
                    ctx, node,
                    f"span {literal!r} documented with cat="
                    f"{DOCUMENTED_SPANS[literal]!r}, called with "
                    f"cat={cat!r}")
        elif (tail in self._METRIC_KINDS
                and head.split(".")[-1] in ("metrics", "_metrics")):
            if literal is not None and literal not in DOCUMENTED_METRICS:
                yield self.finding(
                    ctx, node,
                    f"metric name {literal!r} is not in the documented "
                    "metric table (docs/architecture.md)")

    @staticmethod
    def _kw(node: ast.Call, key: str) -> str | None:
        for kw in node.keywords:
            if kw.arg == key:
                return _str_const(kw.value)
        return None


class JournalKeysRule(Rule):
    """Journal records use only the documented short keys.

    The trials.jsonl grammar is ``{"k","o","v","i"}`` (v2) plus the
    legacy read-only ``"c"``/``"e"`` (v1).  Any other single-letter key
    in a journal record dict is an undocumented schema extension that
    resume/doctor would silently drop.
    """

    id = "journal-keys"
    description = "journal record literal with undocumented keys"

    _REQUIRED = frozenset({"k", "o", "v"})
    _ALLOWED = frozenset({"k", "o", "v", "i", "c", "e"})

    def applies(self, path: str) -> bool:
        return path.replace("\\", "/").endswith("orchestrator/store.py")

    def check(self, node: ast.AST, ctx: FileContext) -> Iterator[Finding]:
        if isinstance(node, ast.Dict):
            keys = [_str_const(k) for k in node.keys]
            if any(k is None for k in keys):
                return
            kset = set(keys)
            # only dicts that look like journal records (share a core key)
            if not (kset & self._REQUIRED and all(len(k) == 1 for k in keys)):
                return
            bad = sorted(kset - self._ALLOWED)
            if bad:
                yield self.finding(
                    ctx, node,
                    f"journal record key(s) {bad} outside the documented "
                    "{'k','o','v','i'} grammar")
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "rec"):
                key = _str_const(t.slice)
                if (key is not None and len(key) == 1
                        and key not in self._ALLOWED):
                    yield self.finding(
                        ctx, node,
                        f"journal record key {key!r} outside the documented "
                        "{'k','o','v','i'} grammar")


class ModelStoreKeysRule(Rule):
    """Surrogate model files use only the documented header fields.

    The ``*.model.json`` grammar is fixed by :data:`MODEL_HEADER_FIELDS`
    (the surrogate store's ``HEADER_FIELDS``); a header dict literal
    with any other key is an undocumented schema extension that
    ``parse_model`` (strict by design, mirroring servedb) would reject
    on the next load — i.e. it would quarantine every file this code
    writes.
    """

    id = "model-store-keys"
    description = "model-store header literal with undocumented fields"

    def applies(self, path: str) -> bool:
        return path.replace("\\", "/").endswith("surrogate/store.py")

    def check(self, node: ast.AST, ctx: FileContext) -> Iterator[Finding]:
        if not isinstance(node, ast.Dict):
            return
        keys = [_str_const(k) for k in node.keys]
        if any(k is None for k in keys) or "magic" not in keys:
            return
        bad = sorted(set(keys) - set(MODEL_HEADER_FIELDS))
        if bad:
            yield self.finding(
                ctx, node,
                f"model header field(s) {bad} outside the documented "
                "HEADER_FIELDS grammar; parse_model would quarantine "
                "files written with them")


class LookupRaiseRule(Rule):
    """The serving lookup path never raises.

    ``servedb/lookup.py``'s public functions sit on the serving hot
    path; their contract is graceful degradation (fall through the
    tier chain to ``default``), so a ``raise`` in a public function is
    a contract violation — route errors into the tier chain instead.
    """

    id = "lookup-raise"
    description = "raise escaping a public servedb lookup function"

    def applies(self, path: str) -> bool:
        return path.replace("\\", "/").endswith("servedb/lookup.py")

    def check(self, node: ast.AST, ctx: FileContext) -> Iterator[Finding]:
        if not isinstance(node, ast.Raise):
            return
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not anc.name.startswith("_"):
                    yield self.finding(
                        ctx, node,
                        f"raise inside public lookup function "
                        f"{anc.name}(); the serving contract is "
                        "never-raise — degrade to the default tier")
                return  # innermost function decides


class BrokerTxRule(Rule):
    """Broker SQLite mutations go through the IMMEDIATE-transaction helper.

    Every INSERT/UPDATE/DELETE in ``broker.py`` must execute inside
    ``with self._tx() as cur:`` (which takes BEGIN IMMEDIATE and retries
    busy errors); a bare mutation can interleave with a concurrent
    lease and double-assign a job.  A helper whose ``cur`` *parameter*
    is the transaction cursor (e.g. ``_reap_cur``) is in scope of its
    caller's transaction and passes.
    """

    id = "broker-tx"
    description = "SQLite mutation outside the _tx() transaction helper"

    _MUTATION = re.compile(r"^\s*(INSERT|UPDATE|DELETE|REPLACE)\b",
                           re.IGNORECASE)

    def applies(self, path: str) -> bool:
        return path.replace("\\", "/").endswith("orchestrator/broker.py")

    def check(self, node: ast.AST, ctx: FileContext) -> Iterator[Finding]:
        if not (isinstance(node, ast.Call) and node.args):
            return
        # match any `<expr>.execute(...)` — the receiver may be a call
        # chain (self._conn().execute) a plain _dotted can't name
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in ("execute", "executemany")):
            return
        sql = _str_const(node.args[0])
        if sql is None or not self._MUTATION.match(sql):
            return
        if self._inside_tx(node, ctx):
            return
        verb = sql.split()[0].upper()
        yield self.finding(
            ctx, node,
            f"{verb} executed outside `with self._tx() as cur:`; all "
            "broker mutations must use the IMMEDIATE-transaction helper")

    @staticmethod
    def _inside_tx(node: ast.AST, ctx: FileContext) -> bool:
        for anc in ctx.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    call = item.context_expr
                    if (isinstance(call, ast.Call)
                            and (_dotted(call.func) or "").endswith("_tx")):
                        return True
            elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a helper taking the transaction cursor as a parameter
                # runs in its caller's transaction scope
                if any(a.arg == "cur" for a in anc.args.args):
                    return True
            elif isinstance(anc, ast.ClassDef) and anc.name == "_Tx":
                return True  # the helper's own internals
        return False


class RetrySleepRule(Rule):
    """Retry loops use ``core/retry.py``, not ad-hoc sleeps.

    ``time.sleep`` inside an ``except`` handler is hand-rolled backoff:
    unsalted, unbounded and invisible to the retry budget.  Route it
    through ``repro_torch.core.retry.retry_call``/``backoff_delays`` (idle
    polling sleeps in loop bodies are fine).
    """

    id = "retry-sleep"
    description = "time.sleep backoff inside an except handler"

    def applies(self, path: str) -> bool:
        return not path.replace("\\", "/").endswith("core/retry.py")

    def check(self, node: ast.AST, ctx: FileContext) -> Iterator[Finding]:
        if not (isinstance(node, ast.Call)
                and _dotted(node.func) == "time.sleep"):
            return
        for anc in ctx.ancestors(node):
            if isinstance(anc, ast.ExceptHandler):
                yield self.finding(
                    ctx, node,
                    "time.sleep in an except handler is ad-hoc retry "
                    "backoff; use repro_torch.core.retry (retry_call / "
                    "backoff_delays) for salted, capped retries")
                return
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return  # left the handler scope


def default_rules() -> list[Rule]:
    """All shipped rules, the set ``lint`` runs."""
    return [WallClockRule(), GlobalRngRule(), ChaosSiteRule(),
            TelemetryNameRule(), JournalKeysRule(), ModelStoreKeysRule(),
            LookupRaiseRule(), BrokerTxRule(), RetrySleepRule()]
