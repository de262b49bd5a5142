"""Host-side minimal-solver geometry: essential matrix and PnP.

Counterpart of ``estimate_essential`` and ``pnp_ransac`` in
``level_s2fm_tpu/sfm/hostgeom.py`` (their minigeom branches): 5-point
RANSAC with cheirality, and P3P LO-RANSAC with LM refinement, from the
port's own build of the native C++ library. There is no OpenCV fallback;
a call raises if the library cannot be built. ``triangulate_dlt`` (the
``tri_trad`` ablation) is the JAX package's numpy DLT, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..cpp import minigeom


@dataclasses.dataclass
class TwoViewResult:
    success: bool
    R: Optional[np.ndarray] = None      # [3,3], X_c1 = R X_c0 + t
    t: Optional[np.ndarray] = None      # [3]
    inliers: Optional[np.ndarray] = None


@dataclasses.dataclass
class PnPResult:
    success: bool
    R: Optional[np.ndarray] = None      # [3,3] w2c
    t: Optional[np.ndarray] = None      # [3]
    inliers: Optional[np.ndarray] = None


def estimate_essential(kp0: np.ndarray, kp1: np.ndarray, K: np.ndarray,
                       threshold_px: float = 1.0, prob: float = 0.9999) -> TwoViewResult:
    """Relative pose from calibrated 2D-2D matches (5-point RANSAC +
    cheirality)."""
    kp0 = np.ascontiguousarray(kp0, np.float64)
    kp1 = np.ascontiguousarray(kp1, np.float64)
    if kp0.shape[0] < 5:
        return TwoViewResult(False)
    ok, R, t, inl = minigeom.essential_ransac(
        kp0, kp1, np.asarray(K, np.float64), threshold_px, prob)
    if ok:
        return TwoViewResult(True, R, t, inl)
    return TwoViewResult(False)


def pnp_ransac(p2d: np.ndarray, p3d: np.ndarray, K: np.ndarray,
               max_error_px: float = 3.0, refine: bool = True) -> PnPResult:
    """Absolute pose from 2D-3D matches (P3P RANSAC + LM refinement)."""
    p2d = np.ascontiguousarray(p2d, np.float64)
    p3d = np.ascontiguousarray(p3d, np.float64)
    if p3d.shape[0] < 4:
        return PnPResult(False)
    ok, R, t, inl = minigeom.pnp_ransac(p2d, p3d, np.asarray(K, np.float64),
                                        max_error_px, refine)
    if ok:
        return PnPResult(True, R, t, inl)
    return PnPResult(False)


def triangulate_dlt(kp0: np.ndarray, kp1: np.ndarray,
                    P0: np.ndarray, P1: np.ndarray) -> np.ndarray:
    """Batch DLT triangulation. kp0/kp1 [N,2] pixels, P0/P1 [3,4]
    projection matrices (K @ [R|t]). Returns [N,3] world points."""
    N = kp0.shape[0]
    A = np.zeros((N, 4, 4))
    A[:, 0] = kp0[:, 0, None] * P0[2] - P0[0]
    A[:, 1] = kp0[:, 1, None] * P0[2] - P0[1]
    A[:, 2] = kp1[:, 0, None] * P1[2] - P1[0]
    A[:, 3] = kp1[:, 1, None] * P1[2] - P1[1]
    _, _, Vt = np.linalg.svd(A)
    X = Vt[:, -1]
    return (X[:, :3] / (X[:, 3:4] + 1e-12)).astype(np.float32)
