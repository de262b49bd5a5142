"""Host-side SfM scene state: cameras, 3D points, feature tracks.

Counterpart of the part of ``level_s2fm_tpu/sfm/entities.py`` that
two-view initialization uses: structure-of-arrays numpy state; device
work happens in the phases. Pose math runs on the CPU in float32 through
the port's ``geometry.lie``. Multi-view pose evaluation (Procrustes),
pruning and BA bookkeeping wait for the registration and BA slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry import lie


def pad_to_bucket(n: int, buckets=(64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
                                   32768, 65536, 131072)) -> int:
    """Round n up to a bucket size (keeps batch shapes in a small set)."""
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@dataclasses.dataclass
class Camera:
    """Per-view host state."""
    id: int
    img: np.ndarray                  # [H,W,3] float32 in [0,1]
    intr: np.ndarray                 # [3,3]
    pose_gt: np.ndarray              # [3,4] w2c
    kypts: np.ndarray                # [K,2]
    matches: List[np.ndarray]        # per other image: [M_i,2] kypt-index pairs
    inlier_masks: List[np.ndarray]   # per other image: [M_i] bool
    se3: np.ndarray = None           # [6] learnable w2c pose (host copy)
    idx2d_to_3d: np.ndarray = None   # [K] int, -1 = untracked

    def __post_init__(self):
        self.se3 = (np.zeros(6, np.float32) if self.se3 is None
                    else np.array(self.se3, np.float32))
        self.idx2d_to_3d = (-np.ones(self.kypts.shape[0], np.int64)
                            if self.idx2d_to_3d is None
                            else np.array(self.idx2d_to_3d, np.int64))

    def pose(self) -> np.ndarray:
        return lie.se3_to_SE3(_t(self.se3[None]))[0].numpy()


class CameraSet:
    """Ordered collection keyed by dataset id."""

    def __init__(self):
        self.cameras: List[Camera] = []
        self.cam_ids: List[int] = []

    def __len__(self):
        return len(self.cameras)

    def add(self, cam: Camera):
        self.cam_ids.append(cam.id)
        self.cameras.append(cam)

    def __call__(self, cam_id: int) -> Camera:
        return self.cameras[self.cam_ids.index(cam_id)]

    def all_poses(self, pick_ids: Optional[Sequence[int]] = None):
        cams = self.cameras if pick_ids is None else [self(i) for i in pick_ids]
        poses = np.stack([c.pose() for c in cams], 0)
        poses_gt = np.stack([c.pose_gt for c in cams], 0)
        return poses, poses_gt

    def eval_poses(self, pick_ids: Optional[Sequence[int]] = None, verbose=True):
        """Relative rotation / translation-direction error of two views
        against GT. Returns (rot_err_deg, t_err_deg, ate=nan)."""
        poses, poses_gt = self.all_poses(pick_ids)
        if poses.shape[0] != 2:
            raise NotImplementedError(
                "eval_poses over more than two views (Procrustes alignment) "
                "waits for the registration slice (ROADMAP Queue 1)")
        if not np.isfinite(poses).all():
            print("WARNING: eval_poses: non-finite pose(s) — pose metrics are nan")
            return float("nan"), float("nan"), float("nan")
        p, g = _t(poses), _t(poses_gt)
        rel_gt = lie.pose_compose_pair(lie.pose_invert(g[0]), g[1])
        rel_est = lie.pose_compose_pair(lie.pose_invert(p[0]), p[1])
        t_e = float(lie.translation_angle_deg(rel_est[:3, 3], rel_gt[:3, 3]))
        r_deg = float(np.rad2deg(float(
            lie.rotation_distance(rel_gt[:3, :3], rel_est[:3, :3]))))
        if verbose:
            print(f"rot_error:{r_deg}")
            print(f"t_error:{t_e}")
        return r_deg, t_e, float("nan")


class PointSet:
    """Append-only 3D point store with feature tracks, backed by a
    growable array."""

    def __init__(self, capacity: int = 4096):
        self.xyz = np.zeros((capacity, 3), np.float32)
        self.n = 0
        self.tracks: List[List[Tuple[int, int]]] = []

    def __len__(self):
        return self.n

    def _grow(self, need: int):
        while self.n + need > self.xyz.shape[0]:
            self.xyz = np.concatenate([self.xyz, np.zeros_like(self.xyz)], 0)

    def add_points(self, xyzs: np.ndarray,
                   tracks: List[List[Tuple[int, int]]]) -> np.ndarray:
        """Append [M,3] points; returns their indices."""
        m = xyzs.shape[0]
        self._grow(m)
        idx = np.arange(self.n, self.n + m)
        self.xyz[self.n:self.n + m] = xyzs
        self.tracks.extend([list(t) for t in tracks])
        self.n += m
        return idx

    def all_xyzs(self) -> np.ndarray:
        return self.xyz[:self.n]
