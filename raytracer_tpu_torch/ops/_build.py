"""Build the port's CUDA sources, and the native host library, into shared
libraries and load them.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``build/raytracer_tpu_torch/lib<name>-<hash>.so`` under the repository
root, at first use. The hash covers the source and the flags, so an edited
source is rebuilt. The library is loaded with ``ctypes``. ``build`` holds
one lock per source, so callers may build several sources at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math, and FMA contraction off
(``-fmad=false``) so that the kernels round after every operation exactly
as their plain PyTorch versions do.

``build_host`` compiles C++ sources with the host compiler the same way
(hash, lock, per-process temporary file, atomic rename): ``utils/native.py``
builds ``native/*.cpp`` with it.
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


def _digest(sources: list[str], flags) -> str:
    """First 16 hex digits of the sha256 of the sources and the flags."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` with the current flags lives."""
    digest = _digest([os.path.join(CSRC, f"{name}.cu")], NVCC_FLAGS)
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def compile_once(key: str, path: str, command, what: str) -> tuple[str, str]:
    """Run ``command(tmp)`` to build ``path`` unless it exists, under the
    lock of ``key``: the output goes to a per-process temporary file that is
    renamed into place, so concurrent builders (threads or processes) never
    see half a file. Returns (path, compiler output, empty when the library
    was already built); raises ``RuntimeError`` with the compiler's output
    when it fails."""
    with _lock(key):
        if os.path.exists(path):
            return path, ""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        res = subprocess.run(command(tmp), capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{what} failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)  # atomic
        return path, res.stdout + res.stderr


def build(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` if its library is missing.

    Returns (library path, compiler output: ptxas' registers, stack and
    spills per kernel; empty when the library was already built). Raises
    ``RuntimeError`` with the compiler's output when nvcc fails.
    """
    src = os.path.join(CSRC, f"{name}.cu")
    return compile_once(name, library_path(name),
                        lambda tmp: [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src], f"nvcc building {name}")


def cxx_path() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on PATH."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found (set CXX); the native host library cannot be built")
    return found


def build_host(name: str, sources: list[str], flags, libs=()) -> tuple[str, str]:
    """Compile the C++ ``sources`` in place into
    ``BUILD_DIR/lib<name>-<hash>.so`` with ``cxx_path()``, ``flags`` and
    ``libs`` (the hash covers the sources and the flags), if it is missing.
    Returns (library path, compiler output); raises ``RuntimeError`` with
    the compiler's output when the build fails."""
    path = os.path.join(BUILD_DIR, f"lib{name}-{_digest(sources, [*flags, *libs])}.so")
    return compile_once(name, path, lambda tmp: [cxx_path(), *flags, "-o", tmp, *sources, *libs],
                        f"{os.environ.get('CXX') or 'g++'} building {name}")


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use)."""
    path, _ = build(name)
    return ctypes.CDLL(path)
