"""Host-side SfM scene state: cameras, 3D points, feature tracks.

Counterpart of ``level_s2fm_tpu/sfm/entities.py``: structure-of-arrays
numpy state; device work happens in the phases. Pose math runs on the
CPU in float32 through the port's ``geometry.lie`` and
``geometry.transforms`` (Procrustes alignment for more than two views).
Besides the cameras and points: post-BA outlier pruning, the host-side
mean reprojection error of the BA guard, geometry snapshots, the
covisible track observations BA optimizes, and ``get_parameters`` (the
checkpointed state).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry import lie
from ..geometry import transforms as T


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

    def rel_index(self, other_id: int) -> int:
        """Index into matches/inlier_masks for the pair (self, other):
        the per-image match lists exclude the image itself."""
        return other_id if other_id < self.id else other_id - 1

    def matched_kypt_ids(self, other_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """Inlier keypoint index pairs (self_idx, other_idx) vs other view."""
        rel = self.rel_index(other_id)
        m = self.matches[rel].astype(np.int64)
        mask = self.inlier_masks[rel].astype(bool)
        return m[mask, 0], m[mask, 1]


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

    def index_of(self, cam_id: int) -> int:
        return self.cam_ids.index(cam_id)

    def all_se3(self, pick_ids: Optional[Sequence[int]] = None) -> np.ndarray:
        cams = self.cameras if pick_ids is None else [self(i) for i in pick_ids]
        return np.stack([c.se3 for c in cams], 0)

    def all_poses(self, pick_ids: Optional[Sequence[int]] = None):
        cams = self.cameras if pick_ids is None else [self(i) for i in pick_ids]
        poses = np.stack([c.pose() for c in cams], 0)
        poses_gt = np.stack([c.pose_gt for c in cams], 0)
        return poses, poses_gt

    def eval_poses(self, pick_ids: Optional[Sequence[int]] = None, verbose=True):
        """Pose errors against GT. More than two views: Procrustes-aligned
        rotation / translation errors and ATE, falling back to the
        unaligned poses when the alignment fails or is non-finite. Two
        views: relative rotation and translation-direction error (deg),
        ate = nan. Non-finite poses give nan metrics."""
        poses, poses_gt = self.all_poses(pick_ids)
        finite_rows = np.isfinite(poses).all(axis=(1, 2))
        if not finite_rows.all():
            ids = self.cam_ids if pick_ids is None else list(pick_ids)
            bad = [ids[i] for i in np.where(~finite_rows)[0]]
            print(f"WARNING: eval_poses: non-finite pose(s) for cam ids "
                  f"{bad} — pose metrics are nan this step")
            return float("nan"), float("nan"), float("nan")
        p, g = _t(poses), _t(poses_gt)
        if poses.shape[0] > 2:
            try:
                aligned, _ = T.prealign_cameras(p, g)
                if not bool(torch.isfinite(aligned).all()):
                    print("WARNING: eval_poses: Procrustes alignment "
                          "returned non-finite sim3 (degenerate camera "
                          "layout?); falling back to unaligned poses")
                    aligned = p
            except Exception as e:
                print(f"WARNING: eval_poses: Procrustes alignment failed "
                      f"({e}); falling back to unaligned poses")
                aligned = p
            R_err, t_err, ate = T.evaluate_camera_alignment(
                lie.pose_invert(aligned), lie.pose_invert(g))
            r_deg = float(np.rad2deg(R_err.numpy().mean()))
            t_e = float(t_err.numpy().mean())
            ate = float(ate)
        else:
            rel_gt = lie.pose_compose_pair(lie.pose_invert(g[0]), g[1])
            rel_est = lie.pose_compose_pair(lie.pose_invert(p[0]), p[1])
            t_e = float(lie.translation_angle_deg(rel_est[:3, 3], rel_gt[:3, 3]))
            r_deg = float(np.rad2deg(float(
                lie.rotation_distance(rel_gt[:3, :3], rel_est[:3, :3]))))
            ate = float("nan")
        if verbose:
            print(f"rot_error:{r_deg}")
            print(f"t_error:{t_e}")
        return r_deg, t_e, ate

    def get_parameters(self) -> Dict:
        """Checkpointable camera state: se3 per camera, dataset ids and
        keypoint-to-point maps."""
        return {
            "pose_para": self.all_se3(),
            "cam_id": list(self.cam_ids),
            "idx2d_to_3ds": [c.idx2d_to_3d.copy() for c in self.cameras],
        }


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

    def get_xyzs(self, idxs) -> np.ndarray:
        return self.xyz[np.asarray(idxs, np.int64)]

    def all_xyzs(self) -> np.ndarray:
        return self.xyz[:self.n]

    def update_xyzs(self, idxs, xyzs_new: np.ndarray):
        self.xyz[np.asarray(idxs, np.int64)] = xyzs_new

    def update_feat_tracks(self, idxs, new_entries: List[Tuple[int, int]]):
        for i, e in zip(idxs, new_entries):
            self.tracks[int(i)].append(tuple(e))

    def remove_observation(self, pid: int, cam_pos: int, kypt_idx: int):
        """Drop one (camera_position, keypoint) entry from a track."""
        t = self.tracks[int(pid)]
        if (int(cam_pos), int(kypt_idx)) in t:
            t.remove((int(cam_pos), int(kypt_idx)))

    def alive_mask(self) -> np.ndarray:
        """Points still referenced by at least one track entry."""
        return np.asarray([len(t) > 0 for t in self.tracks], bool)

    def get_parameters(self) -> Dict:
        """Checkpointable point state: xyz and feature tracks (``xyz``
        and ``tracks`` are also what the COLMAP export reads)."""
        return {"xyzs": self.all_xyzs().copy(),
                "feat_tracks": [list(t) for t in self.tracks]}


def _reprojection(cam: Camera, pointset: PointSet):
    """(tracked keypoint ids, pixel error, depth) of a camera's tracked
    observations under its current pose."""
    kidx = np.where(cam.idx2d_to_3d != -1)[0]
    pts = pointset.get_xyzs(cam.idx2d_to_3d[kidx])
    pose = cam.pose()
    uvw = (pts @ pose[:, :3].T + pose[:, 3]) @ cam.intr.T
    z = uvw[:, 2]
    uv = uvw[:, :2] / np.clip(z[:, None], 1e-6, None)
    return kidx, np.linalg.norm(uv - cam.kypts[kidx], axis=-1), z


def prune_outlier_observations(cameraset: CameraSet, pointset: PointSet,
                               thr_px: float, min_track: int = 2,
                               max_cam_frac: float = 0.25):
    """Drop observations whose reprojection exceeds ``thr_px`` (or that
    fall behind the image plane), then retire points whose track shrinks
    below ``min_track`` by freeing their remaining keypoints (freed
    keypoints flip back to -1 and can be triangulated again). A camera
    with more than ``max_cam_frac`` bad observations is skipped: its pose,
    not its matches, is the suspect. Returns (n_removed, n_retired)."""
    n_removed = 0
    for ci, cam in enumerate(cameraset.cameras):
        kidx, err, z = _reprojection(cam, pointset)
        if len(kidx) == 0:
            continue
        bad = (err > thr_px) | (z <= 1e-6)
        if bad.mean() > max_cam_frac and len(kidx) >= 8:
            continue
        for k in kidx[bad]:
            pid = int(cam.idx2d_to_3d[k])
            cam.idx2d_to_3d[k] = -1
            pointset.remove_observation(pid, ci, int(k))
            n_removed += 1
    n_retired = 0
    for pid, track in enumerate(pointset.tracks):
        if 0 < len(track) < min_track:
            for ci, k in list(track):
                if cameraset.cameras[ci].idx2d_to_3d[k] == pid:
                    cameraset.cameras[ci].idx2d_to_3d[k] = -1
            track.clear()
            n_retired += 1
    return n_removed, n_retired


def mean_reprojection_px(cameraset: CameraSet, pointset: PointSet,
                         cam_ids: Optional[Sequence[int]] = None) -> float:
    """Mean reprojection error (px) over the tracked observations of
    ``cam_ids`` (all cameras when None); nan when there are none."""
    cams = (cameraset.cameras if cam_ids is None
            else [cameraset(i) for i in cam_ids])
    errs = [e for e in (_reprojection(c, pointset)[1] for c in cams) if len(e)]
    if not errs:
        return float("nan")
    return float(np.concatenate(errs).mean())


def snapshot_geometry(cameraset: CameraSet, pointset: PointSet):
    """Rollback point for one BA cycle: copies of the camera se3 and the
    point xyz (the caller keeps its own copy of the field parameters)."""
    return ([c.se3.copy() for c in cameraset.cameras],
            pointset.xyz[:pointset.n].copy())


def restore_geometry(cameraset: CameraSet, pointset: PointSet, snap):
    se3s, xyz = snap
    for c, s_ in zip(cameraset.cameras, se3s):
        c.se3 = np.array(s_, np.float32)
    pointset.xyz[:len(xyz)] = xyz


def gather_track_observations(cameraset: CameraSet, cam_ids: Sequence[int]):
    """Covisible (point_idx, pose_idx, kypt2d) triplets for BA."""
    pts_id, pose_idx, kypts = [], [], []
    for local_i, cid in enumerate(cam_ids):
        cam = cameraset(cid)
        mask = cam.idx2d_to_3d != -1
        pts_id.append(cam.idx2d_to_3d[mask])
        pose_idx.append(np.full(int(mask.sum()), local_i, np.int64))
        kypts.append(cam.kypts[mask])
    if len(pts_id) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros((0, 2), np.float32))
    return (np.concatenate(pts_id), np.concatenate(pose_idx),
            np.concatenate(kypts).astype(np.float32))
