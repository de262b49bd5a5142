"""2D visualization utilities: match drawing, keypoint overlays, pose
plots, depth colorizing.

Counterpart of ``level_s2fm_tpu/utils/vis.py``. ``colorize`` needs no
plotting library: it maps through the viridis table (matplotlib's 256
entries, stored here at 16 bits). ``draw_matches`` and ``draw_keypoints``
draw with OpenCV and ``plot_poses`` plots with matplotlib, each imported
inside the function; images are written with the port's PNG writer
(``utils/png.py``).
"""
from __future__ import annotations

import base64
import functools
import os
from typing import Optional

import numpy as np

from . import png

_VIRIDIS_B64 = (
    "WkQ/AVRUvUR1At5VG0W+A2RXdEUbBeZYyEWLBmRaGEYQCN1bY0aqCVJdqUZOC8Ne6kbjDC5g"
    "J0drDpVhX0fpD/dikUdeEVRkv0fLEqxl6EczFP9mDUiWFUxoLEj0FpRpRkhPGNZqXEimGRJs"
    "bUj7GklteEhNHHpuf0idHaVvgUjrHspwf0g3IOhxd0iCIQFza0jMIhN0WkgUJB91REhaJSV2"
    "KUigJiR3CkjlJx1450coKQ95v0drKvt5kkesK+F6YUftLL97LEcsLph88kZrL2l9tEaoMDV+"
    "c0blMfp+LUYhM7h/40VbNHCAlkWVNSKBRUXNNs6B8UQEOHOCmUQ6ORKDPkRvOqyD4EOjOz+E"
    "f0PVPM2EG0MGPlWFtUI2P9iFS0JkQFWG4EGRQcyGckG9Qj+HAkHnQ6yHkEAQRRWIHEA4RnmI"
    "pj9eR9iILz+CSDOJtj6lSYmJPD7GStyJwT3mSyqKRj0FTXSKyTwhTruKSzw9T/6KzTtXUD2L"
    "TztvUXqL0DqGUrOLUTqbU+mL0jmvVByMUznCVU2M1DjTVnqMVTjjV6aM1zfxWM+MWTf+WfWM"
    "3DYJWxqNXzYUXDyN4zUdXV2NaDUlXnyN7jQrX5mNdDQxYLSN/DM1Yc2NhDM4YuaNDjM6Y/yN"
    "mDI7ZBKOJDI7ZSaOsDE6ZjmOPjE4Z0uOzTA1aFuOXTAxaWuO7i8sanmOgC8na4eOFC8hbJOO"
    "qC4abZ+OPi4SbqmO1C0Kb7OOay0BcLyOBC34cMSOnSzuccuONyzkctGO0ivZc9aObivNdNqO"
    "CivBdd6Opyq1duCORSqpd+KO4ymceOKOgimPeeKOISmBeuCOwShze92OYShmfNmOAShYfdSO"
    "oidJfs6OQyc7f8aO5CYsgL2OhSYegbOOJyYPgqeOySUAg5qObCXyg4uODyXjhHuOsiTUhWmO"
    "ViTFhlWO+iO2hz+OnyOniCeORSOZiQ6O6yKKivKNlCJ7i9SNPSJsjLSN6CFdjZKNlCFPjm2N"
    "QyFAj0aN9CAykB2NqCAjkfGMXyAUksKMGiAGk5CM2B/3k1yMmx/plCWMYx/aleuLMB/Mlq2L"
    "Ax+9l22L3R6vmCqLvh6gmeOKpx6RmpmKmB6Cm0uKkh5znPqJlh5knaaJpB5Vnk6Jvh5Fn/KI"
    "4h42oJKIEx8moS+IUB8WosiHmh8Fo1yH8R/1o+2GVyDkpHqGyiDSpQOGTCHApoiF3CGupwiF"
    "eyKcqISEKSOJqfyD5SN1qm+DryRhq96CiCVMrEmCcCY3ra+BZSchrhGBaSgLr26Aeinzr8Z/"
    "mCrbsBp/wyvCsWl++yypsrR9Py6Os/l8jy9ztDp86zBXtXZ7UjI6tq56xDMbt+B5QTX8tw55"
    "yDbcuDZ4Wji6uVp39TmYunl2mjt0u5N1Rz1PvKh0/j4ovbdzvkABvsJyhkLYvshxVkStv8lw"
    "LkaCwMVvD0hUwbtu9kklwq1t5kv1wpls3E3Dw4Fr2k+PxGNq31FaxUFp6lMjxhlo/FXqxuxm"
    "FVivx7plNFpzyINkWVw0yUdjhF70yQZitmCxysBg7WJty3VfKmUnzCVebGfezNBctGmTzXZb"
    "AmxGzhZaVG73zrJYrHCmz0lXCXNS0NtVa3X80GlU0nek0fFSPXpJ0nVRrXzs0vRPIn+N025O"
    "moEq1ORMGITG1FZLmYZf1cJJHon11StIp4uJ1o9GNI4a1+9ExJCp10xDWJM12KRB7pW+2Pk/"
    "iJhF2Us+JZvJ2Zk8xZ1K2uQ6Z6DJ2i05C6NF23Q3sqW/27k1W6g23P0zBaur3EAysa0d3YMw"
    "XrCN3ccuDLP73Qwtu7Vm3lQra7jO3qApG7s13/Eny72Z30kme8D836okKsNc4BYj2cW74JAh"
    "h8gY4RogM8tz4bke3s3N4W4dh9Al4kAcLtN84jEb09XS4kcadtgn44YZFtt64/MYst3N45AY"
    "TOAg5GIY4uJy5GoYdOXD5KkYA+gU5R8Zjupl5cgZFO235aQalu8I5q4bFPJZ5uMcjvSr5j4e"
    "Avf+5rofcvlR51Yh3vuk5wwjRf7559kk")


@functools.lru_cache(maxsize=1)
def _viridis() -> np.ndarray:
    q = np.frombuffer(base64.b64decode("".join(_VIRIDIS_B64)), "<u2")
    return (q.astype(np.float64) / 65535.0).reshape(256, 3)


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return np.ascontiguousarray(img)


def _save(store_path: str, canvas: np.ndarray):
    os.makedirs(os.path.dirname(store_path) or ".", exist_ok=True)
    png.write_png(store_path, canvas)


def draw_matches(img0, img1, kp0, kp1, store_path: Optional[str] = None,
                 vis_num: Optional[int] = None):
    """Side-by-side match visualization (lines drawn when OpenCV imports).
    ``store_path`` is written as PNG."""
    img0, img1 = _to_u8(img0), _to_u8(img1)
    H = max(img0.shape[0], img1.shape[0])
    W = img0.shape[1] + img1.shape[1]
    canvas = np.zeros((H, W, 3), np.uint8)
    canvas[:img0.shape[0], :img0.shape[1]] = img0
    canvas[:img1.shape[0], img0.shape[1]:] = img1
    kp0 = np.asarray(kp0)
    kp1 = np.asarray(kp1)
    n = len(kp0) if vis_num is None else min(vis_num, len(kp0))
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        rng = np.random.default_rng(0)
        for i in range(n):
            c = tuple(int(x) for x in rng.integers(60, 255, 3))
            p0 = tuple(np.round(kp0[i]).astype(int))
            p1 = tuple(np.round(kp1[i] + [img0.shape[1], 0]).astype(int))
            cv2.circle(canvas, p0, 2, c, -1)
            cv2.circle(canvas, p1, 2, c, -1)
            cv2.line(canvas, p0, p1, c, 1)
    if store_path:
        _save(store_path, canvas)
    return canvas


def draw_keypoints(img, kypts, store_path: Optional[str] = None,
                   color=(255, 0, 0)):
    """Keypoint overlay (circles drawn when OpenCV imports)."""
    canvas = _to_u8(img).copy()
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        for p in np.round(np.asarray(kypts)).astype(int):
            cv2.circle(canvas, tuple(p), 2, color, 2)
    if store_path:
        _save(store_path, canvas)
    return canvas


def camera_centers(poses: np.ndarray) -> np.ndarray:
    """w2c [N,3,4] -> camera centers [N,3]."""
    poses = np.asarray(poses)
    R = poses[:, :, :3]
    t = poses[:, :, 3]
    return -np.einsum("nij,ni->nj", R, t)


def get_camera_wireframe(pose: np.ndarray, depth: float = 0.1) -> np.ndarray:
    """Pyramid wireframe polyline [10,3] for one w2c pose [3,4]: apex and
    image-plane rectangle as one connected line strip."""
    pose = np.asarray(pose, np.float64)
    R, t = pose[:, :3], pose[:, 3]
    C = -R.T @ t
    corners_c = np.asarray([[-0.5, -0.5, 1], [0.5, -0.5, 1],
                            [0.5, 0.5, 1], [-0.5, 0.5, 1]]) * depth
    corners = corners_c @ R + C
    return np.asarray([C, corners[0], corners[1], C, corners[1], corners[2],
                       C, corners[2], corners[3], C])


def plot_poses(poses_pred: np.ndarray, poses_gt: Optional[np.ndarray] = None,
               store_path: Optional[str] = None, frustum_scale: float = 0.1):
    """3D camera-pose plot with frustum wireframes; pred/GT pairs linked
    by dotted lines (w2c [N,3,4] arrays). Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(5, 5), dpi=90)
    ax = fig.add_subplot(111, projection="3d")
    poses_pred = np.asarray(poses_pred)
    c_pred = camera_centers(poses_pred)
    for p in poses_pred:
        w = get_camera_wireframe(p, depth=frustum_scale)
        ax.plot(w[:, 0], w[:, 1], w[:, 2], c="#1f4e79", lw=0.8)
    ax.plot(c_pred[:, 0], c_pred[:, 1], c_pred[:, 2], "o-", c="#1f4e79",
            label="pred", ms=3)
    if poses_gt is not None:
        poses_gt = np.asarray(poses_gt)
        c_gt = camera_centers(poses_gt)
        for p in poses_gt:
            w = get_camera_wireframe(p, depth=frustum_scale)
            ax.plot(w[:, 0], w[:, 1], w[:, 2], c="#c0392b", lw=0.8, alpha=0.6)
        ax.plot(c_gt[:, 0], c_gt[:, 1], c_gt[:, 2], "o--", c="#c0392b",
                label="gt", ms=3)
        for a, b in zip(c_pred, c_gt):
            ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], ":",
                    c="#777777", lw=0.7)
    ax.legend()
    if store_path:
        os.makedirs(os.path.dirname(store_path) or ".", exist_ok=True)
        fig.savefig(store_path)
    plt.close(fig)
    return fig


def colorize(gray: np.ndarray, cmap: str = "viridis",
             vmin: Optional[float] = None,
             vmax: Optional[float] = None) -> np.ndarray:
    """Scalar map [H,W] -> RGB float [H,W,3] through the viridis table
    (matplotlib's lookup: index min(int(256 x), 255)). Non-finite pixels
    map to black."""
    if cmap != "viridis":
        raise ValueError(f"colorize: only the viridis table is built in, "
                         f"not {cmap!r}")
    gray = np.asarray(gray, np.float64)
    finite = np.isfinite(gray)
    lo = vmin if vmin is not None else (gray[finite].min() if finite.any() else 0.0)
    hi = vmax if vmax is not None else (gray[finite].max() if finite.any() else 1.0)
    norm = np.zeros_like(gray)
    if hi > lo:
        norm = np.clip((gray - lo) / (hi - lo), 0, 1)
    idx = np.clip((np.where(finite, norm, 0.0) * 256).astype(np.int64), 0, 255)
    rgb = _viridis()[idx]
    rgb[~finite] = 0.0
    return rgb.astype(np.float32)


def dump_images(out_dir: str, name: str, images, cmap: Optional[str] = None):
    """Save a batch of images [N,H,W(,3)] as PNGs ``<name>_<i>.png``;
    scalar maps are colorized via ``colorize``."""
    os.makedirs(out_dir, exist_ok=True)
    images = np.asarray(images)
    if images.ndim == 3:  # scalar maps
        images = np.stack([colorize(im, cmap or "viridis") for im in images])
    paths = []
    for i, im in enumerate(images):
        p = os.path.join(out_dir, f"{name}_{i}.png")
        png.write_png(p, _to_u8(im))
        paths.append(p)
    return paths
