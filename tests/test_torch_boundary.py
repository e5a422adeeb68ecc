"""The port's boundary: ``repro_torch`` imports neither JAX nor anything of
the JAX package ``repro``, its entry points default to the card and raise
without one, and no library product sits on its kernel paths."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as devmod  # noqa: E402
from repro_torch import landscape, quickstart  # noqa: E402
from repro_torch.core.problem import MeasuredProblem  # noqa: E402
from repro_torch.kernels.attention.space import AttentionProblem  # noqa: E402
from repro_torch.kernels.matmul.space import (GemmProblem,  # noqa: E402
                                              inputs_from_numpy)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    # every submodule was walked, the kernel package's too
    assert {"repro_torch.kernels.matmul.space",
            "repro_torch.kernels.attention.space",
            "repro_torch.landscape"} <= set(got["modules"])
    assert got["bad"] == [], f"repro_torch loaded {got['bad']}"


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


_ARRAYS = {"a": np.ones((2, 2), np.float32), "alpha": 1.0}

ENTRY_POINTS = {
    "device.resolve": lambda: devmod.resolve(),
    "GemmProblem": lambda: GemmProblem(),
    "MeasuredProblem": lambda: MeasuredProblem(
        GemmProblem(device="cpu").space, lambda cfg: (lambda: None)),
    "inputs_from_numpy": lambda: inputs_from_numpy(_ARRAYS),
    "quickstart.main": lambda: quickstart.main(small=True, budget=1,
                                               sample=1),
    "AttentionProblem": lambda: AttentionProblem(),
    "quickstart.main(flash_attention_h100)": lambda: quickstart.main(
        problem="flash_attention_h100", small=True, budget=1, sample=1),
    "landscape.main": lambda: landscape.main(small=True),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(entry, monkeypatch):
    """With no card and no ``device``, every entry point raises: nothing
    falls back to the host unless the caller asks for it."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_entry_points_run_on_the_host_when_asked(monkeypatch):
    _no_card(monkeypatch)
    assert devmod.resolve("cpu").type == "cpu"
    prob = GemmProblem(device="cpu")
    assert prob.arch == "cpu" and prob.name == "gemm_h100"
    x = inputs_from_numpy(_ARRAYS, device="cpu")
    assert x["a"].dtype == torch.bfloat16 and x["alpha"] == 1.0


def test_measured_problem_refuses_another_arch():
    """A measurement belongs to the device it ran on."""
    prob = GemmProblem(shape={"m": 64, "n": 64, "k": 64}, device="cpu")
    cfg = prob.space.sample_distinct(1, 0)[0]
    with pytest.raises(ValueError, match="arch"):
        prob.evaluate(cfg, "h100")


def test_measured_problem_records_the_device_arch():
    """A bare ``MeasuredProblem`` on the host records its trials under the
    host's arch, with the median, min, max and repeat count."""
    space = GemmProblem(shape={"m": 64, "n": 64, "k": 64}, device="cpu").space
    prob = MeasuredProblem(space, lambda cfg: (lambda: None), repeats=3,
                           warmup=1, device="cpu")
    t = prob.evaluate(space.sample_distinct(1, 0)[0])
    assert t.ok and t.arch == prob.arch == "cpu"
    assert t.info["repeats"] == 3
    assert t.info["min_s"] <= t.info["median_s"] <= t.info["max_s"]
    with pytest.raises(ValueError, match="arch"):
        prob.evaluate(space.sample_distinct(1, 0)[0], "h100")


_PRODUCT_CALLS = {"matmul", "mm", "bmm", "addmm", "baddbmm", "einsum",
                  "scaled_dot_product_attention", "compile", "linear"}


def _products(tree: ast.AST) -> list[int]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            out.append(node.lineno)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _PRODUCT_CALLS:
            out.append(node.lineno)
    return out


#: each kernel package and its plain version, the one function beside the
#: oracle (ref.py) that may hold torch products
PLAIN = {"matmul": "gemm_plain", "attention": "flash_attention_plain"}


@pytest.mark.parametrize("module", ["kernel.py", "ops.py", "space.py"])
@pytest.mark.parametrize("package", list(PLAIN))
def test_no_library_product_on_the_kernel_path(package, module):
    """Torch products live only in the oracle (ref.py) and in the plain
    version (``kernel.gemm_plain``, ``kernel.flash_attention_plain``); the
    kernel path has none."""
    tree = ast.parse((PORT / "kernels" / package / module).read_text())
    allowed = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name == PLAIN[package]:
            allowed |= set(_products(fn))
    assert sorted(set(_products(tree)) - allowed) == []
