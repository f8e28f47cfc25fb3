"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into `vvc_mm_tpu_torch/_build/lib<name>.so`, then
loaded with ctypes; the `csrc/*.cuh` headers are shared by the sources.
Nothing is built when a module is imported: the first launch builds (or
reuses a build newer than its source and the headers), and
`build_all()` compiles every source at once, one `nvcc` each, in parallel.
While tracing (utils/profiling.py), `build_all` and each first `load` are
spans (`build`, `load`) that count the `nvcc_compiles` they start.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from ..utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# flags of one source only: the sources that include libm_f32.cuh must
# round every multiply and add on its own unless they ask for an fma()
SOURCE_FLAGS = {"libm_f32": ["-fmad=false"],
                "sphere_positions": ["-fmad=false"]}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(CSRC, name + ".cu"),
            os.path.join(BUILD, f"lib{name}.so"))


def _start_build(name: str):
    """Start nvcc for one source unless its library is up to date; returns
    (process, tmp path, so path) or None."""
    src, so = _paths(name)
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
               if f.endswith(".cuh")]
    newest = max(os.path.getmtime(f) for f in [src, *headers])
    if os.path.exists(so) and os.path.getmtime(so) >= newest:
        return None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-Xptxas",
           "-v", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    profiling.count("nvcc_compiles")
    return proc, tmp, so


def _finish_build(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, so)
    return out


def build_all() -> dict[str, str]:
    """Compile every csrc/*.cu in parallel; returns each one's ptxas
    report (empty where the library was already up to date)."""
    with profiling.span("build"):
        jobs = {n: _start_build(n) for n in sources()}
        return {n: _finish_build(n, j) for n, j in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if needed."""
    if name not in _libs:
        with profiling.span("load"):
            _finish_build(name, _start_build(name))
            _libs[name] = ctypes.CDLL(_paths(name)[1])
    return _libs[name]
