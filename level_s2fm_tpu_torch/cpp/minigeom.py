"""ctypes bindings for the native minigeom library (C++).

The port's own copy of ``native/minigeom.cpp`` and ``native/build.sh``
(byte for byte the JAX package's) is built at first use with g++ and the
flags of ``build.sh`` into ``../_build/`` (listed in ``.gitignore``),
under a name keyed by the hash of the source and flags, as
``kernels.build`` does for the CUDA sources: an edited source is rebuilt,
and concurrent builders each write a private file that is renamed into
place, so none loads a half-written library. It provides the pycolmap-equivalent host
geometry: 5-point essential RANSAC with cheirality, P3P LO-RANSAC and LM
pose refinement. ``load()`` raises if the library cannot be built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "native", "minigeom.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-Wall"]       # those of build.sh


def library_path(source: str, stem: str) -> str:
    """``_build/lib<stem>-<hash of source and flags>.so``."""
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_GXX_FLAGS).encode()
                              ).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"lib{stem}-{digest}.so")


def build_shared(source: str, stem: str) -> str:
    """Build ``source`` into a shared library with g++ if it is missing;
    return its path. Raises if the build fails."""
    path = library_path(source, stem)
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(["g++", *_GXX_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {stem} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def _lib_path() -> str:
    return library_path(_SOURCE, "minigeom")


def build() -> str:
    """Build the minigeom library if it is missing; return its path."""
    return build_shared(_SOURCE, "minigeom")


def load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        dptr = ctypes.POINTER(ctypes.c_double)
        u8ptr = ctypes.POINTER(ctypes.c_uint8)
        lib.mg_essential_ransac.restype = ctypes.c_int
        lib.mg_essential_ransac.argtypes = [
            dptr, dptr, ctypes.c_int, dptr,                  # kp0, kp1, n, K
            ctypes.c_double, ctypes.c_double, ctypes.c_int,  # thresh_px, prob, max_iters
            dptr, dptr, u8ptr]                               # out R, t, inliers
        lib.mg_pnp_ransac.restype = ctypes.c_int
        lib.mg_pnp_ransac.argtypes = [
            dptr, dptr, ctypes.c_int, dptr,                  # p2d, p3d, n, K
            ctypes.c_double, ctypes.c_int, ctypes.c_int,     # max_err_px, max_iters, refine
            dptr, dptr, u8ptr]                               # out R, t, inliers
        _LIB = lib
        return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def essential_ransac(kp0: np.ndarray, kp1: np.ndarray, K: np.ndarray,
                     threshold_px: float = 1.0, prob: float = 0.9999,
                     max_iters: int = 1000):
    lib = load()
    n = kp0.shape[0]
    kp0 = np.ascontiguousarray(kp0, np.float64)
    kp1 = np.ascontiguousarray(kp1, np.float64)
    K = np.ascontiguousarray(K, np.float64)
    R = np.zeros((3, 3), np.float64)
    t = np.zeros(3, np.float64)
    inl = np.zeros(n, np.uint8)
    ok = lib.mg_essential_ransac(_dp(kp0), _dp(kp1), n, _dp(K),
                                 threshold_px, prob, max_iters,
                                 _dp(R), _dp(t),
                                 inl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return bool(ok), R.astype(np.float32), t.astype(np.float32), inl.astype(bool)


def pnp_ransac(p2d: np.ndarray, p3d: np.ndarray, K: np.ndarray,
               max_error_px: float = 3.0, refine: bool = True,
               max_iters: int = 1000):
    """P3P LO-RANSAC (seeded, deterministic) + LM refinement on the
    inliers. Returns (ok, R [3,3] w2c, t [3], inlier mask [N])."""
    lib = load()
    n = p2d.shape[0]
    p2d = np.ascontiguousarray(p2d, np.float64)
    p3d = np.ascontiguousarray(p3d, np.float64)
    K = np.ascontiguousarray(K, np.float64)
    R = np.zeros((3, 3), np.float64)
    t = np.zeros(3, np.float64)
    inl = np.zeros(n, np.uint8)
    ok = lib.mg_pnp_ransac(_dp(p2d), _dp(p3d), n, _dp(K),
                           max_error_px, max_iters, 1 if refine else 0,
                           _dp(R), _dp(t),
                           inl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return bool(ok), R.astype(np.float32), t.astype(np.float32), inl.astype(bool)
