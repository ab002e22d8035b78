"""nvcc builds of the port's CUDA sources (``lime_tpu_torch/csrc/*.cu``).

Each source compiles by hand into its own shared library with a plain C
interface under ``build/lime_tpu_torch/`` (``-gencode
arch=compute_90a,code=sm_90a``), at first use and again whenever the
source is newer than its library; the kernel modules load the library
with ctypes.  A build writes a pid-suffixed temp file and renames it onto
the library, so concurrent processes never load a half-written file.
:func:`compile_all` starts one nvcc per stale source, all at once.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "lime_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def source_path(name: str) -> str:
    """``csrc/<name>.cu``."""
    return os.path.join(CSRC_DIR, f"{name}.cu")


def lib_path(name: str) -> str:
    """``build/lime_tpu_torch/lib<name>.so``."""
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           f"sources in {CSRC_DIR}")
    return path


def _stale(name: str) -> bool:
    lib = lib_path(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(source_path(name)) > os.path.getmtime(lib))


def compile_all(names: Sequence[str], verbose: bool = False
                ) -> Dict[str, str]:
    """Build every stale source of ``names`` with one nvcc each, run in
    parallel.  Returns nvcc's stderr per built source (``-Xptxas -v``
    register and shared-memory report when ``verbose``); raises with the
    compiler's output if any build fails."""
    stale = [n for n in names if _stale(n)]
    if not stale:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in stale:
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", tmp, source_path(name)]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs, errors = {}, []
    for name, (cmd, tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
            continue
        os.replace(tmp, lib_path(name))
        logs[name] = err
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs
