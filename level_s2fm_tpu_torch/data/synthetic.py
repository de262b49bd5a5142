"""Synthetic sphere scene: a self-contained stand-in for a prepared dataset.

Copy of the sphere scene of ``level_s2fm_tpu/data/synthetic.py`` (the
port imports nothing of the JAX package): per-image keypoints, all-pairs
match matrix with inlier masks, pose graph and ray-cast ground-truth
images, all numpy and seeded, so the arrays are bitwise equal to the
JAX package's. The hard and multiroom scenes are not ported yet.

Scene: textured sphere of radius ``sphere_rad`` at the origin, cameras on
a ring looking inward, keypoints = projections of shared surface points.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def _look_at_w2c(cam_pos: np.ndarray, target: np.ndarray, up=(0, 1, 0)) -> np.ndarray:
    """Build a w2c [3,4] pose for a camera at cam_pos looking at target."""
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R_c2w = np.stack([x, y, z], axis=1)  # columns are camera axes in world
    R = R_c2w.T
    t = -R @ cam_pos
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def _sphere_color(p: np.ndarray, detail: float = 0.0) -> np.ndarray:
    """Position-dependent albedo in (0.1, 0.9). ``detail`` adds
    high-frequency bands so SIFT finds corners on rendered images (needed
    when a scene goes through the real preparation pipeline)."""
    s = np.stack([np.sin(3.1 * p[..., 0]) * np.cos(2.3 * p[..., 1]),
                  np.sin(2.7 * p[..., 1]) * np.cos(3.7 * p[..., 2]),
                  np.sin(1.9 * p[..., 2]) * np.cos(2.9 * p[..., 0])], axis=-1)
    c = 0.5 + 0.4 * s
    if detail > 0:
        c = np.clip(c + detail * (_random_texture(p) - 0.5), 0.05, 0.95)
    return c


_TEX_CACHE = {}


def _random_texture(p: np.ndarray, res: int = 256, seed: int = 1234):
    """Non-repeating random texture sampled by spherical coordinates.

    A periodic analytic texture self-matches under SIFT's ratio test;
    a seeded random map gives every surface patch a unique fingerprint,
    which is what the real preparation pipeline needs."""
    key = (res, seed)
    if key not in _TEX_CACHE:
        rng = np.random.default_rng(seed)
        # LUMINANCE-correlated noise: SIFT detects on the grayscale image,
        # so per-channel-independent noise cancels ~1/sqrt(3) in gray and
        # the detector starves (measured: 13 vs ~400 keypoints at 320px).
        # One shared luminance field plus a small chroma tint keeps the
        # gray-plane contrast while still exercising the RGB loss.
        lum = rng.uniform(size=(res, res, 1)).astype(np.float32)
        tint = rng.uniform(size=(res, res, 3)).astype(np.float32)
        tex = lum + 0.15 * (tint - 0.5)
        # smooth to a feature scale of a few texels: sub-texel detail
        # aliases view-dependently and breaks descriptor matching
        for _ in range(5):
            tex = 0.5 * tex + 0.125 * (np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
                                       + np.roll(tex, 1, 1) + np.roll(tex, -1, 1))
        t = tex - tex.mean()
        tex = 0.5 + 0.5 * t / (np.abs(t).max() + 1e-9)   # re-stretch contrast
        _TEX_CACHE[key] = tex.astype(np.float32)
    tex = _TEX_CACHE[key]
    r = np.linalg.norm(p, axis=-1) + 1e-12
    theta = np.arccos(np.clip(p[..., 2] / r, -1, 1)) / np.pi          # [0,1]
    phi = (np.arctan2(p[..., 1], p[..., 0]) + np.pi) / (2 * np.pi)    # [0,1]
    # bilinear sample
    uf = theta * (res - 1)
    vf = phi * (res - 1)
    u0 = np.clip(np.floor(uf).astype(np.int64), 0, res - 2)
    v0 = np.clip(np.floor(vf).astype(np.int64), 0, res - 2)
    du = (uf - u0)[..., None]
    dv = (vf - v0)[..., None]
    return (tex[u0, v0] * (1 - du) * (1 - dv) + tex[u0 + 1, v0] * du * (1 - dv)
            + tex[u0, v0 + 1] * (1 - du) * dv + tex[u0 + 1, v0 + 1] * du * dv)


def _raycast_sphere(pose_w2c, K, H, W, rad, detail: float = 0.0):
    """Analytic render of the textured sphere; returns [H,W,3] float32."""
    R, t = pose_w2c[:, :3], pose_w2c[:, 3]
    cam_pos = -R.T @ t
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    dirs_cam = pix @ np.linalg.inv(K).T
    dirs = dirs_cam @ R  # R.T @ d, batched
    oc = cam_pos
    a = np.sum(dirs * dirs, axis=-1)
    b = 2 * dirs @ oc
    c = oc @ oc - rad ** 2
    disc = b * b - 4 * a * c
    hit = disc > 0
    tdep = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    pts = cam_pos[None] + tdep[:, None] * dirs
    img = np.zeros((H * W, 3), np.float32)
    img[hit] = _sphere_color(pts[hit], detail=detail)
    return img.reshape(H, W, 3)


@dataclasses.dataclass
class SyntheticScene:
    images: np.ndarray          # [N,H,W,3]
    intrs: np.ndarray           # [N,3,3]
    poses_gt: np.ndarray        # [N,3,4] w2c
    kypts: List[np.ndarray]     # per image [K,2]
    matches: List[List[np.ndarray]]      # [N][N-1] match index pairs
    masks: List[List[np.ndarray]]        # [N][N-1] inlier masks
    pose_graph: List[int]
    surface_pts: np.ndarray     # [M,3] GT surface points behind the keypoints


def make_scene(n_views=4, H=64, W=64, n_points=256, sphere_rad=0.5,
               ring_rad=2.0, seed=0, noise_px=0.0,
               detail: float = 0.0) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    f = 0.9 * W
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)

    # shared 3D surface points (front hemisphere-ish band so most are visible)
    pts = rng.normal(size=(n_points * 4, 3))
    pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True) * sphere_rad
    pts = pts[: n_points]

    poses, images = [], []
    for i in range(n_views):
        # fixed arc step so the two-view baseline (~0.47 for ring_rad=2) is
        # independent of n_views — configs/synthetic.yaml's scale_init
        # assumes it
        ang = 0.2356 * i
        cam_pos = np.asarray([ring_rad * np.sin(ang), 0.35,
                              -ring_rad * np.cos(ang)])
        pose = _look_at_w2c(cam_pos, np.zeros(3))
        poses.append(pose)
        images.append(_raycast_sphere(pose, K, H, W, sphere_rad,
                                      detail=detail))
    poses = np.stack(poses)
    images = np.stack(images)

    # visibility: point visible if its normal faces the camera and projects in-frame
    kypts, vis_ids = [], []
    for i in range(n_views):
        R, t = poses[i][:, :3], poses[i][:, 3]
        cam_pos = -R.T @ t
        Xc = pts @ R.T + t
        uv = Xc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        facing = np.sum(pts / sphere_rad * (cam_pos[None] - pts), axis=-1) > 0
        inframe = (uv[:, 0] > 2) & (uv[:, 0] < W - 2) & (uv[:, 1] > 2) & (uv[:, 1] < H - 2)
        v = facing & inframe & (Xc[:, 2] > 0)
        ids = np.where(v)[0]
        uv_v = uv[ids].astype(np.float32)
        if noise_px > 0:
            uv_v = uv_v + rng.normal(scale=noise_px, size=uv_v.shape).astype(np.float32)
        kypts.append(uv_v)
        vis_ids.append(ids)

    # all-pairs symmetric matches through shared point ids
    matches = [[None] * (n_views - 1) for _ in range(n_views)]
    masks = [[None] * (n_views - 1) for _ in range(n_views)]
    for i in range(n_views):
        for j in range(n_views):
            if i == j:
                continue
            rel = j if j < i else j - 1
            common, ii, jj = np.intersect1d(vis_ids[i], vis_ids[j],
                                            return_indices=True)
            m = np.stack([ii, jj], axis=1).astype(np.int64)
            matches[i][rel] = m
            masks[i][rel] = np.ones(m.shape[0], bool)

    return SyntheticScene(images=images, intrs=np.broadcast_to(K, (n_views, 3, 3)).copy(),
                          poses_gt=poses, kypts=kypts, matches=matches, masks=masks,
                          pose_graph=list(range(n_views)), surface_pts=pts)


def scene_to_var(scene: SyntheticScene) -> Dict:
    """Package a scene the way the pipeline's `load_matches` does
    (ref `LevelS2fM.py:76-90`)."""
    return {
        "kypts": scene.kypts,
        "matches": scene.matches,
        "masks": scene.masks,
        "poses_gt": scene.poses_gt,
        "images": scene.images,
        "intrs": scene.intrs,
        "pose_graph": scene.pose_graph,
    }
