"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``_build/`` (listed in ``.gitignore``) under a name keyed
by the hash of its source and flags, so an edited source is rebuilt and
an unchanged one is reused. Nothing is compiled at import time: the
first wrapper call builds its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: ptxas report (registers, shared memory, spills) per built library
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the GPU machine with the CUDA toolkit")
    return cand


def library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(
            ARCH_FLAGS + NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` if its library is missing; return the
    library path."""
    return compile_source(os.path.join(CSRC, f"{name}.cu"), library_path(name), name)


def compile_source(src: str, out: str, name: str) -> str:
    """nvcc ``src`` into the shared library ``out`` unless it exists,
    through a private temporary file renamed into place; the ptxas
    report goes to ``BUILD_LOG[name]``. Returns ``out``."""
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    BUILD_LOG[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
        return lib


def check(status: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {status}")
