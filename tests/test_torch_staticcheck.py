"""The port's copy of the static contract checker
(``repro_torch.staticcheck``) held against the JAX package's
(``repro.staticcheck``): every snippet of ``tests/test_staticcheck.py``
gives the same rule ids on the same lines under both engines; both rule
sets find the same on the JAX package's tree; the copy lints the port's
tree clean, where the JAX package's registry flags the one span the port
adds (``pool.retry``); baselines, parse errors, the space audit of every
port problem on the host, and the CLI's ``lint`` and ``doctor --lint``."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.staticcheck as ref  # noqa: E402
import repro_torch.staticcheck as port  # noqa: E402
from repro.core.surrogate.store import HEADER_FIELDS  # noqa: E402
from repro.orchestrator import chaos as ref_chaos  # noqa: E402
from repro.staticcheck import rules as ref_rules  # noqa: E402
from repro_torch.orchestrator import chaos as port_chaos  # noqa: E402
from repro_torch.orchestrator.cli import main as port_cli  # noqa: E402
from repro_torch.orchestrator.doctor import diagnose, render_report  # noqa: E402
from repro_torch.orchestrator.registry import (PROBLEM_PATHS,  # noqa: E402
                                               make_problem, problem_names)
from repro_torch.orchestrator.store import SessionStore  # noqa: E402
from repro_torch.staticcheck import rules as port_rules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _snippets() -> list[tuple[str, str, str]]:
    """(test name, path, code) of every ``lint(path, code)`` call with two
    literal arguments in the JAX package's staticcheck tests."""
    tree = ast.parse((ROOT / "tests" / "test_staticcheck.py").read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name) and n.func.id == "lint"
                 and len(n.args) == 2
                 and all(isinstance(a, ast.Constant) for a in n.args)]
        for i, c in enumerate(calls):
            out.append((f"{fn.name}[{i}]", c.args[0].value, c.args[1].value))
    return out


SNIPPETS = _snippets()


def _found(engine_mod, path: str, code: str) -> list[tuple[str, int]]:
    eng = engine_mod.Engine(engine_mod.default_rules())
    return [(f.rule, f.line)
            for f in eng.lint_source(path, textwrap.dedent(code))]


def test_the_snippets_cover_every_rule():
    """The parametrised cases below reach each rule, flagged and not, and
    the suppressions and the parse error."""
    assert len(SNIPPETS) >= 30
    flagged = {r for _, p, c in SNIPPETS for r, _ in _found(ref, p, c)}
    assert flagged >= {r.id for r in ref.default_rules()} | {"parse-error"}
    assert any(not _found(ref, p, c) for _, p, c in SNIPPETS)
    assert {n.split("[")[0] for n, _, _ in SNIPPETS} >= {
        "test_same_line_suppression", "test_comment_line_suppresses_next_line",
        "test_suppression_is_rule_specific"}


@pytest.mark.parametrize("prefix", ["repro", "repro_torch"])
@pytest.mark.parametrize("name,path,code", SNIPPETS,
                         ids=[n for n, _, _ in SNIPPETS])
def test_snippet_findings_are_the_references(name, path, code, prefix):
    """The same rule ids on the same lines under both engines, with the
    snippet's path as the JAX package's tests give it and moved into the
    port's package."""
    path = prefix + path[len("repro"):]
    assert _found(port, path, code) == _found(ref, path, code)


def test_rule_set_and_registries_are_the_references():
    assert [r.id for r in port.default_rules()] \
        == [r.id for r in ref.default_rules()]
    assert port_rules.DETERMINISTIC_PATHS == ref_rules.DETERMINISTIC_PATHS
    assert port_rules.DOCUMENTED_METRICS == ref_rules.DOCUMENTED_METRICS
    assert port_rules.MODEL_HEADER_FIELDS == HEADER_FIELDS
    # the rule reads the port's own model store's header grammar
    from repro_torch.core.surrogate.store import \
        HEADER_FIELDS as PORT_HEADER_FIELDS
    assert port_rules.MODEL_HEADER_FIELDS is PORT_HEADER_FIELDS
    assert port_chaos.SITES == ref_chaos.SITES
    # the one difference: the port's pool emits pool.retry
    extra = {k: v for k, v in port_rules.DOCUMENTED_SPANS.items()
             if k not in ref_rules.DOCUMENTED_SPANS}
    assert extra == {"pool.retry": "pool"}
    assert {k: port_rules.DOCUMENTED_SPANS[k]
            for k in ref_rules.DOCUMENTED_SPANS} == ref_rules.DOCUMENTED_SPANS


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_both_rule_sets_on_both_trees(pkg):
    """On the JAX package's tree both find the same (nothing); on the
    port's the copy finds nothing and the JAX package's registry flags the
    port's ``pool.retry`` span alone, which is why the copy's differs."""
    rf = ref.Engine(ref.default_rules(), root=SRC).lint_paths([SRC / pkg])
    pf = port.Engine(port.default_rules(), root=SRC).lint_paths([SRC / pkg])
    assert pf == [], "\n".join(f.render() for f in pf)
    if pkg == "repro":
        assert rf == []
    else:
        assert [(f.rule, f.path) for f in rf] == [
            ("telemetry-name", "repro_torch/orchestrator/workers.py")]
        assert "'pool.retry'" in rf[0].message


def test_planted_violations_match_the_reference(tmp_path):
    """A tree with one violation of each kind: the copy's findings are the
    reference's, finding for finding."""
    files = {
        "repro_torch/orchestrator/store.py":
            "import time\n\ndef stamp():\n    return time.time()\n"
            "\ndef rec():\n    return {'k': 1, 'o': 2, 'v': 3, 'z': 4}\n",
        "repro_torch/core/tuners/genetic.py":
            "import random\n\ndef draw():\n    return random.random()\n",
        "repro_torch/orchestrator/runner.py":
            "from ..telemetry.trace import span\n"
            "from ..telemetry import metrics\n\ndef f():\n"
            "    with span('session.bogus', cat='session'):\n"
            "        metrics.counter('made.up').inc()\n",
        "repro_torch/orchestrator/workers.py":
            "from . import chaos\n\ndef f():\n    chaos.fire('no.such.site')\n"
            "\ndef g():\n    import time\n    try:\n        pass\n"
            "    except OSError:\n        time.sleep(1)\n",
        "repro_torch/orchestrator/broker.py":
            "def f(conn):\n    conn.execute('DELETE FROM jobs')\n",
        "repro_torch/servedb/lookup.py":
            "def lookup(x):\n    raise KeyError(x)\n",
        "repro_torch/core/surrogate/store.py":
            "HEADER = {'magic': 1, 'version': 2, 'extra': 3}\n",
        "repro_torch/orchestrator/broken.py": "def broken(:\n",
    }
    for rel, code in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(code)
    paths = [tmp_path / "repro_torch"]
    rf = ref.Engine(ref.default_rules(), root=tmp_path).lint_paths(paths)
    pf = port.Engine(port.default_rules(), root=tmp_path).lint_paths(paths)
    assert [(f.rule, f.path, f.line) for f in pf] \
        == [(f.rule, f.path, f.line) for f in rf]
    assert {f.rule for f in pf} == {r.id for r in port.default_rules()} \
        | {"parse-error"}


# --------------------------------------------------------------------- #
# baselines and parse errors
# --------------------------------------------------------------------- #
CLOCK = """
    import time
    def stamp():
        return time.time()
"""


def _lint(path: str, code: str):
    return port.Engine(port.default_rules()).lint_source(
        path, textwrap.dedent(code))


def test_baseline_roundtrip_and_files_match_the_reference(tmp_path):
    findings = _lint("repro_torch/orchestrator/store.py", CLOCK)
    assert [f.rule for f in findings] == ["wall-clock"]
    bl = tmp_path / "baseline.json"
    port.write_baseline(bl, findings)
    assert port.apply_baseline(findings, port.load_baseline(bl)) == []
    fresh = _lint("repro_torch/orchestrator/store.py", """
        import random
        def draw():
            return random.random()
    """)
    assert [f.rule for f in port.apply_baseline(
        fresh, port.load_baseline(bl))] == ["global-rng"]
    # the reference writes the same file for the same findings
    rbl = tmp_path / "ref.json"
    ref.write_baseline(rbl, ref.Engine(ref.default_rules()).lint_source(
        "repro_torch/orchestrator/store.py", textwrap.dedent(CLOCK)))
    assert rbl.read_bytes() == bl.read_bytes()


def test_baseline_key_survives_line_shifts():
    a = _lint("repro_torch/orchestrator/store.py", CLOCK)
    b = _lint("repro_torch/orchestrator/store.py",
              "\n# an unrelated comment\n" + textwrap.dedent(CLOCK))
    assert a[0].line != b[0].line
    assert a[0].baseline_key == b[0].baseline_key


def test_syntax_error_is_a_finding_not_a_crash():
    fs = _lint("repro_torch/orchestrator/store.py", "def broken(:\n")
    assert [f.rule for f in fs] == ["parse-error"]


# --------------------------------------------------------------------- #
# the space audit of the port's problems, on the host
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", problem_names())
def test_every_port_problem_audits_clean_on_the_host(name):
    """``lint --spaces`` builds each problem on the CPU: a kernel problem's
    space is the card's; the copy's audit equals the reference's."""
    kw = {"device": "cpu"} if name in PROBLEM_PATHS else {}
    sp = make_problem(name, **kw).space
    rep = port.audit_space(sp)
    assert rep.ok and rep.n_components == 1, rep.render()
    assert all(f.severity == "info" for f in rep.findings)
    assert rep.to_json() == ref.audit_space(sp).to_json()


def test_port_problems_are_ten():
    assert len(problem_names()) == 10


# --------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------- #
def test_cli_lint_strict_spaces_exits_zero_with_no_card():
    """The acceptance command, as a user runs it on a host with no card."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.orchestrator",
                        "lint", "--strict", "--spaces"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "lint: 0 finding(s), 0/10 space(s) failing — clean" in r.stdout


def test_cli_lint_strict_on_the_tree_and_a_planted_violation(tmp_path,
                                                             capsys):
    assert port_cli(["lint", "--strict"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    bad = tmp_path / "repro_torch" / "orchestrator" / "store.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import time\n\ndef stamp():\n    return time.time()\n")
    assert port_cli(["lint", "--strict", str(bad)]) == 1
    assert "wall-clock" in capsys.readouterr().out
    assert port_cli(["lint", str(bad)]) == 0          # advisory
    assert "wall-clock" in capsys.readouterr().out
    bl = tmp_path / "baseline.json"
    assert port_cli(["lint", "--write-baseline", str(bl), str(bad)]) == 0
    assert bl.exists()
    capsys.readouterr()
    assert port_cli(["lint", "--strict", "--baseline", str(bl),
                     str(bad)]) == 0


def test_cli_lint_json(capsys):
    assert port_cli(["lint", "--json",
                     str(SRC / "repro_torch" / "staticcheck")]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec == {"findings": [], "spaces": [], "ok": True}


def test_doctor_lint_reports_the_port_tree_clean(tmp_path, capsys):
    store = SessionStore(tmp_path / "sessions")
    report = diagnose(store, lint=True)
    assert report["lint"] == {"findings": []} and report["ok"]
    assert "lint: 0 contract finding(s) — clean" in render_report(report)
    assert diagnose(store)["lint"] is None
    assert port_cli(["doctor", "--store", str(tmp_path / "sessions"),
                     "--lint", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["lint"] == {"findings": []}
