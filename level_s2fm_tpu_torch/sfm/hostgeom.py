"""Host-side minimal-solver geometry: the essential matrix.

Counterpart of ``level_s2fm_tpu/sfm/hostgeom.py::estimate_essential``
(its minigeom branch): 5-point RANSAC with cheirality from the port's own
build of the native C++ library. There is no OpenCV fallback; the call
raises if the library cannot be built. PnP and DLT triangulation wait for
the registration slice.
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
