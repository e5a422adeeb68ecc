"""The port's boundary: ``repro_torch`` imports neither JAX nor anything of
the JAX package ``repro``, its entry points default to the card and raise
without one, and no library product sits on its kernel paths."""

import ast
import importlib.util
import json
import os
import re
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
from repro_torch.kernels.conv2d.space import Conv2dProblem  # noqa: E402
from repro_torch.kernels.dedisp.space import DedispProblem  # noqa: E402
from repro_torch.kernels.expdist.space import ExpdistProblem  # noqa: E402
from repro_torch.kernels.hotspot.space import HotspotProblem  # noqa: E402
from repro_torch.kernels.nbody.space import NbodyProblem  # noqa: E402
from repro_torch.kernels.pnpoly.space import PnpolyProblem  # noqa: E402
from repro_torch.kernels.matmul.space import (GemmProblem,  # noqa: E402
                                              inputs_from_numpy)
from repro_torch.orchestrator import (SessionSpec, make_problem,  # noqa: E402
                                      run_session)

from repro_torch.configs import ARCHS, reduce_config  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402
from repro_torch.train import TrainLoop  # noqa: E402

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
            "repro_torch.kernels.nbody.space",
            "repro_torch.kernels.pnpoly.space",
            "repro_torch.kernels.conv2d.space",
            "repro_torch.kernels.hotspot.space",
            "repro_torch.kernels.expdist.space",
            "repro_torch.kernels.dedisp.space",
            "repro_torch.landscape",
            "repro_torch.core.retry",
            "repro_torch.orchestrator",
            "repro_torch.orchestrator.__main__",
            "repro_torch.orchestrator.broker",
            "repro_torch.orchestrator.campaign",
            "repro_torch.orchestrator.chaos",
            "repro_torch.orchestrator.cli",
            "repro_torch.orchestrator.doctor",
            "repro_torch.orchestrator.queue",
            "repro_torch.orchestrator.registry",
            "repro_torch.orchestrator.runner",
            "repro_torch.orchestrator.session",
            "repro_torch.orchestrator.store",
            "repro_torch.orchestrator.supervisor",
            "repro_torch.orchestrator.workers",
            "repro_torch.core.tuners.local_search",
            "repro_torch.core.tuners.annealing",
            "repro_torch.core.tuners.diffevo",
            "repro_torch.core.tuners.pso",
            "repro_torch.core.tuners.surrogate_bo",
            "repro_torch.staticcheck",
            "repro_torch.staticcheck.engine",
            "repro_torch.staticcheck.rules",
            "repro_torch.staticcheck.spaceaudit",
            "repro_torch.servedb",
            "repro_torch.servedb.defaults",
            "repro_torch.servedb.distill",
            "repro_torch.servedb.lookup",
            "repro_torch.servedb.snapshot",
            "repro_torch.core.spacetable",
            "repro_torch.core.surrogate",
            "repro_torch.core.surrogate.dataset",
            "repro_torch.core.surrogate.model",
            "repro_torch.core.surrogate.screen",
            "repro_torch.core.surrogate.store",
            "repro_torch.configs",
            "repro_torch.configs.common",
            "repro_torch.configs.qwen3_8b",
            "repro_torch.models",
            "repro_torch.models.attention",
            "repro_torch.models.convert",
            "repro_torch.models.layers",
            "repro_torch.models.model",
            "repro_torch.models.moe",
            "repro_torch.models.rglru",
            "repro_torch.models.rwkv6",
            "repro_torch.models.transformer",
            "repro_torch.serve",
            "repro_torch.serve.decode",
            "repro_torch.launch",
            "repro_torch.launch.serve",
            "repro_torch.launch.steps",
            "repro_torch.launch.train",
            "repro_torch.data",
            "repro_torch.data.pipeline",
            "repro_torch.train",
            "repro_torch.train.checkpoint",
            "repro_torch.train.optimizer",
            "repro_torch.train.train_loop"} <= set(got["modules"])
    assert got["bad"] == [], f"repro_torch loaded {got['bad']}"


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


_ARRAYS = {"a": np.ones((2, 2), np.float32), "alpha": 1.0}


def _tiny_config():
    return reduce_config(ARCHS["qwen3-8b"])


def _tiny_model():
    return build_model(_tiny_config())

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
    "NbodyProblem": lambda: NbodyProblem(),
    "PnpolyProblem": lambda: PnpolyProblem(),
    "Conv2dProblem": lambda: Conv2dProblem(),
    "quickstart.main(pnpoly_h100)": lambda: quickstart.main(
        problem="pnpoly_h100", small=True, budget=1, sample=1),
    "landscape.main(conv2d_h100)": lambda: landscape.main(
        problem="conv2d_h100", small=True),
    "HotspotProblem": lambda: HotspotProblem(),
    "ExpdistProblem": lambda: ExpdistProblem(),
    "DedispProblem": lambda: DedispProblem(),
    "quickstart.main(dedisp_h100)": lambda: quickstart.main(
        problem="dedisp_h100", small=True, budget=1, sample=1),
    "landscape.main(hotspot_h100)": lambda: landscape.main(
        problem="hotspot_h100", small=True, samples=4),
    "orchestrator.make_problem": lambda: make_problem("gemm_h100"),
    "orchestrator.run_session": lambda: run_session(SessionSpec(
        problem="flash_attention_h100", tuner="random", arch="h100sxm",
        budget=2)),
    "Model.init": lambda: _tiny_model().init(0),
    "Model.load_jax": lambda: _tiny_model().load_jax({}),
    "ServingEngine": lambda: ServingEngine(_tiny_config()),
    "launch.serve.main": lambda: serve_launcher.main(
        ["--arch", "qwen3-8b", "--reduced", "--requests", "1"]),
    "TrainLoop": lambda: TrainLoop(_tiny_config()),
    "launch.train.main": lambda: train_launcher.main(
        ["--arch", "qwen3-8b", "--reduced", "--steps", "1"]),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(entry, monkeypatch):
    """With no card and no ``device``, every entry point raises: nothing
    falls back to the host unless the caller asks for it."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_entry_points_run_on_the_host_when_asked(monkeypatch, tmp_path):
    _no_card(monkeypatch)
    assert devmod.resolve("cpu").type == "cpu"
    assert TrainLoop(_tiny_config(), "cpu").device.type == "cpu"
    out = train_launcher.main(["--arch", "qwen3-8b", "--reduced", "--device",
                               "cpu", "--steps", "1", "--log-every", "1",
                               "--global-batch", "2", "--seq-len", "16",
                               "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 1 and out["device"] == "cpu"
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
                  "scaled_dot_product_attention", "compile", "linear",
                  "conv1d", "conv2d", "conv3d", "conv_transpose2d", "unfold"}


def _products(tree: ast.AST) -> list[int]:
    """Lines of ``@`` products and of calls named in ``_PRODUCT_CALLS``;
    ``ops.conv2d``, the port's own op, is not a library call."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            out.append(node.lineno)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _PRODUCT_CALLS \
                and not (isinstance(node.func.value, ast.Name)
                         and node.func.value.id == "ops"):
            out.append(node.lineno)
    return out


#: each kernel package and its plain version, the one function beside the
#: oracle (ref.py) that may hold torch products
PLAIN = {"matmul": "gemm_plain", "attention": "flash_attention_plain",
         "nbody": "nbody_plain", "pnpoly": "pnpoly_plain",
         "conv2d": "conv2d_plain", "hotspot": "hotspot_plain",
         "expdist": "expdist_plain", "dedisp": "dedisp_plain"}


@pytest.mark.parametrize("module", ["kernel.py", "ops.py", "space.py"])
@pytest.mark.parametrize("package", list(PLAIN))
def test_no_library_product_on_the_kernel_path(package, module):
    """Torch products and convolutions live only in the oracle (ref.py) and
    in the plain version (``kernel.gemm_plain``, ``kernel.nbody_plain``,
    ...); the kernel path has none."""
    tree = ast.parse((PORT / "kernels" / package / module).read_text())
    allowed = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name == PLAIN[package]:
            allowed |= set(_products(fn))
    assert sorted(set(_products(tree)) - allowed) == []


def test_the_product_check_sees_a_convolution():
    """``F.conv2d`` or ``torch.conv2d`` on a kernel path is flagged; the
    port's own ``ops.conv2d`` is not, and the oracle's call is where the
    one convolution of the conv2d package lives."""
    bad = ast.parse("import torch.nn.functional as F\n"
                    "def f(x, w):\n"
                    "    return F.conv2d(x, w) + torch.conv2d(x, w)\n")
    assert _products(bad) == [3, 3]
    assert _products(ast.parse("ops.conv2d(image, filt, cfg)\n")) == []
    ref = ast.parse((PORT / "kernels" / "conv2d" / "ref.py").read_text())
    assert len(_products(ref)) == 1


#: the sources whose launches may take more than 48 KB of dynamic shared
#: memory; hotspot's edge buffers and pnpoly's slopes stay under it
OPTING_IN = {"conv2d.cu", "dedisp.cu", "expdist.cu", "flash_attention.cu",
             "gemm.cu", "nbody.cu"}


def test_shared_memory_opt_in_is_per_device():
    """The opt-in to more than 48 KB of dynamic shared memory is an
    attribute of a kernel on each device.  No launcher remembers it once
    per process (a ``smem_set``) or sets the attribute itself: each one
    whose launches may need it calls ``opt_in_smem`` (``csrc/common.cuh``),
    which remembers it per kernel, per device and per host thread (a
    launch from a thread that did not set it is refused on the card)."""
    common = (PORT / "csrc" / "common.cuh").read_text()
    helper = common[common.index("template <auto K>"):]
    helper = helper[:helper.index("\n}\n")]
    assert "static thread_local int opted[MAX_DEVICES]" in helper
    assert "cudaGetDevice(&dev)" in helper and "opted[dev]" in helper
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in helper
    calling = set()
    for src in sorted((PORT / "csrc").glob("*.cu")):
        text = src.read_text()
        assert "smem_set" not in text, src.name
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" not in text, \
            src.name
        if re.search(r"\bopt_in_smem<\w+>\(", text):
            assert '#include "common.cuh"' in text, src.name
            calling.add(src.name)
    assert calling == OPTING_IN


_FAKE_NVCC = """#!/bin/sh
# a stand-in compiler: names its output after -o, prints a ptxas line,
# fails where a -DFAIL is given
for a in "$@"; do
  case "$prev" in -o) out="$a";; esac
  case "$a" in -DFAIL=*) echo "error: asked to fail"; exit 1;; esac
  prev="$a"
done
echo "ptxas info    : Used 8 registers"
sleep 0.3
touch "$out"
"""


def _fake_toolchain(tmp_path, monkeypatch):
    from repro_torch import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    fake = tmp_path / "nvcc"
    fake.write_text(_FAKE_NVCC)
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    return _build


def test_build_compiles_every_variant_at_once(tmp_path, monkeypatch):
    """``build_all`` starts one compiler a variant, all at once, keeps each
    one's output as its log, records when each ended, and reuses what it
    built."""
    _build = _fake_toolchain(tmp_path, monkeypatch)
    variants = {f"v{i}": {"X": i} for i in range(4)}
    built = _build.build_all({"k.cu": variants})["k.cu"]
    assert all(lib.exists() for lib in built.libs.values())
    assert set(built.finished) == set(variants)
    assert all(0.3 <= t <= built.seconds for t in built.finished.values())
    assert built.seconds < 4 * 0.3           # in parallel, not one by one
    log = built.libs["v0"].parent / "v0.log"
    assert "Used 8 registers" in log.read_text()
    again = _build.build_all({"k.cu": variants})["k.cu"]
    assert again.libs == built.libs
    assert (again.seconds, again.finished) == (0.0, {})


def test_build_raises_with_the_failed_compile_log(tmp_path, monkeypatch):
    _build = _fake_toolchain(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError,
                       match=r"(?s)k\.cu \[bad\] exit 1.*asked to fail"):
        _build.build_all({"k.cu": {"good": {"X": 1}, "bad": {"FAIL": 1}}})


def test_inputs_from_numpy_takes_a_dtype():
    """bf16 by default (GEMM and attention), f32 when asked (nbody, pnpoly,
    conv2d), with the values rounded only by the dtype."""
    a = np.linspace(-2.0, 2.0, 7, dtype=np.float32)
    x = inputs_from_numpy({"a": a, "n": 3}, device="cpu",
                          dtype=torch.float32)
    assert x["a"].dtype == torch.float32 and x["n"] == 3
    assert np.array_equal(x["a"].numpy(), a)
    y = inputs_from_numpy({"a": a}, device="cpu")
    assert y["a"].dtype == torch.bfloat16
    assert torch.equal(y["a"], x["a"].to(torch.bfloat16))


def test_inputs_from_numpy_keeps_integer_arrays_integral():
    """A table of delays stays int32 whatever ``dtype`` the floating
    arrays take; a float cast would break it."""
    delays = np.array([[0, 3], [8192, 7]], np.int64)
    x = inputs_from_numpy({"delays": delays, "x": np.ones(3, np.float32)},
                          device="cpu", dtype=torch.float32)
    assert x["delays"].dtype == torch.int32 and x["x"].dtype == torch.float32
    assert np.array_equal(x["delays"].numpy(), delays)
    y = inputs_from_numpy({"delays": delays.astype(np.int32)}, device="cpu")
    assert y["delays"].dtype == torch.int32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_checks_every_cuda_source():
    """``chip_smoke.py`` looks each kernel up in one table: a row for every
    CUDA source of the port, each op with its launch counter and its count
    of the CUDA kernels it issued, so a kernel cannot be built without
    being held against its plain version and counted on its path."""
    table = _chip_smoke().kernel_table()
    assert {m.SOURCE for m, _ in table.values()} \
        == {p.name for p in (PORT / "csrc").glob("*.cu")}
    for module, op in table.values():
        assert isinstance(op.launches, int) and module.VARIANTS
        assert isinstance(op.device_launches, int)
        assert 0.0 <= module.PLAIN_TOL <= 1e-3


def test_chip_smoke_exits_nonzero_without_a_card():
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
