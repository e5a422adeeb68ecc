"""Build the port's CUDA sources with ``nvcc`` into shared libraries.

Each source under ``csrc/`` is compiled into a plain-C shared library that
:mod:`ctypes` loads (no PyTorch headers, so a build takes seconds, not
minutes).  A source may be built in several variants, each a set of ``-D``
macros; all variants compile at once, one ``nvcc`` process each, and each
leaves its compiler output (``-Xptxas -v``: registers, spills) in
``<variant>.log`` beside its library.  Libraries go to
``build/repro_torch/<source>-<hash>/`` in the checkout, keyed by a
hash of every file in ``csrc/`` and the flags, so an edit rebuilds and an
unchanged tree reuses what it built.  Nothing is built at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    libs: dict[str, Path]       # variant name -> shared library
    seconds: float              # wall time of this build (0.0 if reused)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: building the port's kernels needs "
                       "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _key(source: str, variants: dict[str, dict[str, object]]) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(repr((source, NVCC_FLAGS, sorted(
        (k, sorted(v.items())) for k, v in variants.items()))).encode())
    return h.hexdigest()[:16]


def build(source: str, variants: dict[str, dict[str, object]]) -> Built:
    """Compile ``csrc/<source>`` once per variant, in parallel."""
    stem = Path(source).stem
    out_dir = BUILD_ROOT / f"{stem}-{_key(source, variants)}"
    libs = {v: out_dir / f"lib{stem}_{v}.so" for v in variants}
    if all(p.exists() for p in libs.values()):
        return Built(libs, 0.0)
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for v, defines in variants.items():
        tmp = libs[v].with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS,
               *(f"-D{k}={val}" for k, val in defines.items()),
               "-o", str(tmp), str(CSRC / source)]
        procs[v] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for v, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{v}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {source} [{v}] exit {proc.returncode}\n"
                          f"{log[-4000:]}")
        else:
            os.replace(tmp, libs[v])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return Built(libs, time.perf_counter() - t0)
