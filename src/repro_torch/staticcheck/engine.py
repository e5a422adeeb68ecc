"""AST rule engine behind ``python -m repro_torch.orchestrator lint``.

One parse + one walk per file: the engine builds a :class:`FileContext`
(source lines, parent links, suppression map), then dispatches every AST
node to each registered :class:`Rule` whose ``applies(path)`` says yes.
Rules yield :class:`Finding`\\ s; the engine filters suppressed ones and
(optionally) ones present in a committed JSON baseline.

Suppressions are per-line::

    t0 = time.time()  # repro-lint: disable=wall-clock

A comment-only line suppresses the *next* line, so black-formatted code
can keep the pragma above a long call::

    # repro-lint: disable=wall-clock,retry-sleep
    t0 = time.time()

Baselines let the linter land on a tree with known debt: ``lint
--write-baseline lint-baseline.json`` records today's findings; future
runs with ``--baseline lint-baseline.json`` report only *new* ones.
Baseline keys ignore line numbers so unrelated edits above a known
finding don't resurrect it.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator

__all__ = ["Finding", "Rule", "FileContext", "Engine",
           "load_baseline", "write_baseline", "apply_baseline"]

#: ``# repro-lint: disable=rule-a,rule-b`` (anywhere in a line)
_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([\w,\- ]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    The baseline key is ``(rule, path, message)`` — deliberately not the
    line number, so a committed baseline survives edits elsewhere in the
    file.  ``message`` should therefore describe *what* is wrong (the
    offending name/literal), not *where*.
    """

    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str

    @property
    def baseline_key(self) -> str:
        return f"{self.rule}::{self.path}::{self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path,
                "line": self.line, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Rule:
    """Base class for lint rules.

    Subclasses set ``id`` (kebab-case, the name used in suppressions and
    baselines) and ``description``, optionally narrow ``applies`` to a
    path subset, and implement ``check`` — called once per AST node of
    each applicable file, yielding findings.
    """

    id: str = ""
    description: str = ""

    def applies(self, path: str) -> bool:
        """Whether this rule runs on ``path`` (repo-relative)."""
        return True

    def check(self, node: ast.AST, ctx: "FileContext") -> Iterator[Finding]:
        raise NotImplementedError

    # convenience for subclasses
    def finding(self, ctx: "FileContext", node: ast.AST,
                message: str) -> Finding:
        return Finding(self.id, ctx.path, getattr(node, "lineno", 0), message)


class FileContext:
    """Everything a rule may want about the file being linted."""

    def __init__(self, path: str, source: str, tree: ast.AST):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self._parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        self._suppressed = self._parse_suppressions()

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        """``node``'s chain of parents, innermost first."""
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def _parse_suppressions(self) -> dict[int, set[str]]:
        """line number -> rule ids disabled there.

        A pragma on a code line covers that line; a pragma on a
        comment-only line covers the next line as well.
        """
        out: dict[int, set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out.setdefault(i, set()).update(rules)
            if text.lstrip().startswith("#"):
                out.setdefault(i + 1, set()).update(rules)
        return out

    def suppressed(self, rule_id: str, line: int) -> bool:
        return rule_id in self._suppressed.get(line, set())


class Engine:
    """Walk files once, dispatch nodes to applicable rules."""

    def __init__(self, rules: Iterable[Rule], root: str | Path = "."):
        self.rules = list(rules)
        self.root = Path(root).resolve()
        ids = [r.id for r in self.rules]
        dupes = {i for i in ids if ids.count(i) > 1}
        if dupes or "" in ids:
            raise ValueError(f"rules need unique non-empty ids: {sorted(dupes)}")

    def _rel(self, path: Path) -> str:
        p = path.resolve()
        try:
            return p.relative_to(self.root).as_posix()
        except ValueError:
            return p.as_posix()

    def lint_source(self, path: str, source: str) -> list[Finding]:
        """Lint one already-read file; ``path`` is used for rule scoping
        and reporting.  Syntax errors are themselves findings (rule
        ``parse-error``) rather than crashes — the linter must be safe
        to point at any tree."""
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            return [Finding("parse-error", path, e.lineno or 0,
                            f"syntax error: {e.msg}")]
        ctx = FileContext(path, source, tree)
        active = [r for r in self.rules if r.applies(path)]
        if not active:
            return []
        out: list[Finding] = []
        for node in ast.walk(tree):
            for rule in active:
                for f in rule.check(node, ctx):
                    if not ctx.suppressed(f.rule, f.line):
                        out.append(f)
        out.sort(key=lambda f: (f.path, f.line, f.rule))
        return out

    def lint_file(self, path: str | Path) -> list[Finding]:
        p = Path(path)
        return self.lint_source(self._rel(p), p.read_text())

    def lint_paths(self, paths: Iterable[str | Path]) -> list[Finding]:
        """Lint files and/or directories (recursing into ``*.py``)."""
        files: list[Path] = []
        for p in paths:
            p = Path(p)
            if p.is_dir():
                files.extend(sorted(p.rglob("*.py")))
            else:
                files.append(p)
        out: list[Finding] = []
        for f in files:
            out.extend(self.lint_file(f))
        return out


# --------------------------------------------------------------------- #
# baselines
# --------------------------------------------------------------------- #

def load_baseline(path: str | Path) -> set[str]:
    """The set of baseline keys recorded in a baseline file."""
    rec = json.loads(Path(path).read_text())
    return set(rec.get("findings", []))

def write_baseline(path: str | Path, findings: Iterable[Finding]) -> None:
    keys = sorted({f.baseline_key for f in findings})
    Path(path).write_text(json.dumps(
        {"comment": "repro lint baseline: known findings tolerated by "
                    "--baseline; regenerate with --write-baseline",
         "findings": keys}, indent=1) + "\n")

def apply_baseline(findings: Iterable[Finding],
                   baseline: set[str]) -> list[Finding]:
    """Findings not excused by the baseline."""
    return [f for f in findings if f.baseline_key not in baseline]
