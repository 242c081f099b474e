"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  Libraries
go to ``xvector_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``), keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.  Several sources compile in parallel: one
``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("tdnn_stack.cu", "conv_bwd.cu", "conv_sm90.cu", "fwd_sm90.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build from source")
    return found


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / (Path(source).stem + ".so")


def build(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is not built yet; return the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    per source, empty for one that was already built."""
    nvcc = None
    jobs = []
    logs: Dict[str, str] = {}
    for name in sources:
        out = _lib_path(name)
        if out.exists():
            logs[name] = ""
            continue
        nvcc = nvcc or _nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} "
                          f"(rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)   # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The built library of ``source``, building it first if needed."""
    if source not in _loaded:
        build((source,))
        _loaded[source] = ctypes.CDLL(str(_lib_path(source)))
    return _loaded[source]
