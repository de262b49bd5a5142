"""The benchmark's scenes, in the ``var`` layout the port's pipeline takes
(images, intrinsics, GT poses, keypoints, matches, inlier masks, pose
graph).

- ``synthetic``: the textured sphere of radius 0.5 seen from a ring of
  cameras looking inward; keypoints are the projections of shared
  surface points, matched through their ids (the scene the port's
  ``data/synthetic.py`` makes, restated here so that the inputs do not
  move with the program).
- ``DTU``: a prepared scene on disk (``data.prep_dir``): cameras.npz
  projection matrices split into intrinsics and pose, the images read
  and area-resized to ``data.image_size``, and the preparation's
  keypoints (scaled alike), matches, inlier masks and pose graph. The
  PNG files are decoded by the port's reader, a file-format decoder.
"""
from __future__ import annotations

import os

import numpy as np


# --------------------------------------------------------------------------- sphere

def _look_at(cam_pos, target, up=(0, 1, 0)):
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1).T
    return np.concatenate([R, (-R @ cam_pos)[:, None]], axis=1).astype(np.float32)


def _albedo(p):
    s = np.stack([np.sin(3.1 * p[..., 0]) * np.cos(2.3 * p[..., 1]),
                  np.sin(2.7 * p[..., 1]) * np.cos(3.7 * p[..., 2]),
                  np.sin(1.9 * p[..., 2]) * np.cos(2.9 * p[..., 0])], axis=-1)
    return 0.5 + 0.4 * s


def _raycast(pose, K, H, W, rad):
    R, t = pose[:, :3], pose[:, 3]
    c = -R.T @ t
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    d = (pix @ np.linalg.inv(K).T) @ R
    a = np.sum(d * d, -1)
    b = 2 * d @ c
    disc = b * b - 4 * a * (c @ c - rad ** 2)
    hit = disc > 0
    tdep = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    img = np.zeros((H * W, 3), np.float32)
    img[hit] = _albedo((c[None] + tdep[:, None] * d)[hit])
    return img.reshape(H, W, 3)


def sphere(opt):
    """The sphere scene of ``data.n_views`` views at ``data.image_size``
    with ``data.n_points`` surface points, from the options' seed; also
    ``surface_pts`` and ``vis_ids`` (each keypoint's point id)."""
    n_views = int(opt["data"]["n_views"])
    H, W = opt["data"]["image_size"]
    n_points, rad, ring = int(opt["data"]["n_points"]), 0.5, 2.0
    rng = np.random.default_rng(int(opt["seed"]))
    f = 0.9 * W
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    pts = rng.normal(size=(n_points * 4, 3))
    pts = (pts / np.linalg.norm(pts, axis=-1, keepdims=True) * rad)[:n_points]
    poses, images, kypts, vis = [], [], [], []
    for i in range(n_views):
        ang = 0.2356 * i
        pose = _look_at(np.asarray([ring * np.sin(ang), 0.35, -ring * np.cos(ang)]),
                        np.zeros(3))
        poses.append(pose)
        images.append(_raycast(pose, K, H, W, rad))
        R, t = pose[:, :3], pose[:, 3]
        Xc = pts @ R.T + t
        uv = Xc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        facing = np.sum(pts / rad * ((-R.T @ t)[None] - pts), -1) > 0
        inside = (uv[:, 0] > 2) & (uv[:, 0] < W - 2) & (uv[:, 1] > 2) & (uv[:, 1] < H - 2)
        ids = np.where(facing & inside & (Xc[:, 2] > 0))[0]
        kypts.append(uv[ids].astype(np.float32))
        vis.append(ids)
    matches = [[None] * (n_views - 1) for _ in range(n_views)]
    masks = [[None] * (n_views - 1) for _ in range(n_views)]
    for i in range(n_views):
        for j in range(n_views):
            if i != j:
                _, ii, jj = np.intersect1d(vis[i], vis[j], return_indices=True)
                m = np.stack([ii, jj], 1).astype(np.int64)
                matches[i][j if j < i else j - 1] = m
                masks[i][j if j < i else j - 1] = np.ones(len(m), bool)
    return {"images": np.stack(images), "intrs": np.broadcast_to(K, (n_views, 3, 3)).copy(),
            "poses_gt": np.stack(poses), "kypts": kypts, "matches": matches,
            "masks": masks, "pose_graph": list(range(n_views)),
            "surface_pts": pts, "vis_ids": vis}


# --------------------------------------------------------------------------- DTU layout

def _rq3(M):
    P = np.eye(3)[::-1]
    Q, U = np.linalg.qr((P @ M).T)
    K, R = P @ U.T @ P, P @ Q.T
    s = np.sign(np.diag(K))
    s[s == 0] = 1.0
    s[2] = s[0] * s[1] * np.sign(np.linalg.det(R))
    return K * s[None, :], s[:, None] * R


def _area_weights(src, dst):
    """[dst, src] weights of an area (box) resize along one axis."""
    scale = 1.0 / (dst / src)
    w = np.zeros((dst, src), np.float64)
    for i in range(dst):
        f1 = i * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), min(int(np.floor(f2)), src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[i, s1 - 1] += np.float32((s1 - f1) / cell)
        w[i, s1:s2] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[i, s2] += np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def _image(path, H, W):
    from level_s2fm_tpu_torch.utils.png import read_png
    img = read_png(path)[..., :3].astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.shape[:2] != (H, W):
        img = np.asarray(img, np.float64)
        img = np.tensordot(_area_weights(img.shape[0], H), img, axes=(1, 0))
        img = np.moveaxis(np.tensordot(_area_weights(img.shape[1], W), img, axes=(1, 1)),
                          0, 1).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def dtu(opt):
    d = opt["data"]
    root = os.path.join(d["root"], d["scene"])
    H, W = d["image_size"]
    rawH, rawW = d["raw_size"]
    names = sorted(f for f in os.listdir(os.path.join(root, "images"))
                   if f.lower().endswith(".png"))
    cams = np.load(os.path.join(root, "cameras.npz"))
    intrs, poses, images = [], [], []
    for i, name in enumerate(names):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"]).astype(np.float32)[:3, :4]
        P = np.asarray(P, np.float64)
        K, R = _rq3(P[:, :3])
        K = K / K[2, 2]
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -np.linalg.solve(P[:, :3], P[:, 3])   # the camera centre
        w2c = np.zeros((3, 4), np.float32)
        w2c[:3, :3] = c2w[:3, :3].T
        w2c[:3, 3] = -c2w[:3, :3].T @ c2w[:3, 3]
        poses.append(w2c)
        K = K.astype(np.float32)
        K[0, 0] /= rawW / W
        K[0, 2] /= rawW / W
        K[1, 1] /= rawH / H
        K[1, 2] /= rawH / H
        intrs.append(K)
        images.append(_image(os.path.join(root, "images", name), H, W))
    prep = d["prep_dir"]
    views = np.load(os.path.join(prep, "n_views.npy"), allow_pickle=True)
    scale = np.asarray([rawW / W, rawH / H]).reshape(1, 2)
    return {"images": np.stack(images), "intrs": np.stack(intrs),
            "poses_gt": np.stack(poses),
            "kypts": [np.asarray(v["kypts"]) / scale for v in views],
            "matches": [v["indxes"] for v in views], "masks": [v["mask"] for v in views],
            "pose_graph": list(np.load(os.path.join(prep, "pose_graph.npy"),
                                       allow_pickle=True)[:])}


def load(opt):
    """The scene of the options' ``data.dataset``."""
    kind = opt["data"]["dataset"]
    if kind == "synthetic":
        return sphere(opt)
    if kind == "DTU":
        return dtu(opt)
    raise ValueError(f"no scene reader for data.dataset {kind!r}")
