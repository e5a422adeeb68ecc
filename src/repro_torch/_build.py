"""Build the port's CUDA sources with ``nvcc`` into shared libraries.

Each source under ``csrc/`` is compiled into a plain-C shared library that
:mod:`ctypes` loads (no PyTorch headers, so a build takes seconds, not
minutes).  A source may be built in several variants, each a set of ``-D``
macros; all variants compile at once, one ``nvcc`` process each, and each
leaves its compiler output (``-Xptxas -v``: registers, spills) in
``<variant>.log`` beside its library.  Libraries go to
``build/repro_torch/<source>-<hash>/`` in the checkout, keyed by a
hash of the source, the ``csrc/`` headers it includes and the flags, so an
edit rebuilds what it touches and nothing else, and an unchanged tree
reuses what it built.  :func:`build_all` compiles several sources at once.
Nothing is built at import time.
"""

from __future__ import annotations

import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources_of(source: str) -> list[str]:
    """``source`` and the ``csrc/`` files it includes, transitively, in the
    order first met."""
    seen = [source]
    for name in seen:
        for inc in _INCLUDE.findall((CSRC / name).read_bytes()):
            inc = inc.decode()
            if inc not in seen and (CSRC / inc).exists():
                seen.append(inc)
    return seen


def _key(source: str, variants: dict[str, dict[str, object]]) -> str:
    h = hashlib.sha256()
    for name in sources_of(source):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(repr((source, NVCC_FLAGS, sorted(
        (k, sorted(v.items())) for k, v in variants.items()))).encode())
    return h.hexdigest()[:16]


def build(source: str, variants: dict[str, dict[str, object]]) -> Built:
    """Compile ``csrc/<source>`` once per variant, in parallel."""
    return build_all({source: variants})[source]


def build_all(jobs: dict[str, dict[str, dict[str, object]]]
              ) -> dict[str, Built]:
    """Compile every variant of every source in ``jobs`` (source -> its
    variants) at once, one ``nvcc`` process each.  A source whose libraries
    exist is reused; a failed compile raises with its log's tail."""
    out: dict[str, Built] = {}
    procs = {}
    compiler = None
    t0 = time.perf_counter()
    for source, variants in jobs.items():
        stem = Path(source).stem
        out_dir = BUILD_ROOT / f"{stem}-{_key(source, variants)}"
        libs = {v: out_dir / f"lib{stem}_{v}.so" for v in variants}
        out[source] = Built(libs, 0.0)
        if all(p.exists() for p in libs.values()):
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        compiler = compiler or nvcc()
        for v, defines in variants.items():
            tmp = libs[v].with_suffix(f".{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS,
                   *(f"-D{k}={val}" for k, val in defines.items()),
                   "-o", str(tmp), str(CSRC / source)]
            procs[source, v] = (out_dir, tmp, libs[v], subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed = []
    for (source, v), (out_dir, tmp, lib, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{v}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {source} [{v}] exit {proc.returncode}\n"
                          f"{log[-4000:]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    seconds = time.perf_counter() - t0
    for source in {s for s, _ in procs}:
        out[source].seconds = seconds
    return out
