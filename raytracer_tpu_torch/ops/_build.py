"""Build the port's CUDA sources into shared libraries and load them.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``build/raytracer_tpu_torch/lib<name>-<hash>.so`` under the repository
root, at first use. The hash covers the source and the flags, so an edited
source is rebuilt. The library is loaded with ``ctypes``. ``build`` holds
one lock per source, so callers may build several sources at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math, and FMA contraction off
(``-fmad=false``) so that the kernels round after every operation exactly
as their plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "raytracer_tpu_torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock(name: str) -> threading.Lock:
    """One lock per source, so different sources build at the same time."""
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, /usr/local/cuda, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` with the current flags lives."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` if its library is missing.

    Returns (library path, compiler output: ptxas' registers, stack and
    spills per kernel; empty when the library was already built). Raises
    ``RuntimeError`` with the compiler's output when nvcc fails.
    """
    path = library_path(name)
    with _lock(name):
        if os.path.exists(path):
            return path, ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {name}:\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, path)  # atomic: concurrent builders never see half a file
        return path, res.stdout + res.stderr


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use)."""
    path, _ = build(name)
    return ctypes.CDLL(path)
