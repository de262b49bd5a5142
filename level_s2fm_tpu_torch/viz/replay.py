"""Reconstruction replay viewer: turntable renders of exported artifacts.

Counterpart of ``level_s2fm_tpu/viz/replay.py``: loads the exported PLY
point cloud / mesh and ``cameras.json`` and renders a turntable image
sequence with matplotlib (imported when the function runs), written as
PNG frames, or as a GIF through imageio.

Usage: python -m level_s2fm_tpu_torch.viz.replay --run output/<run> \
           [--frames 36] [--out replay.gif]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from ..utils import png
from ..utils.marching_cubes import read_ply


def camera_frustum_lines(K, W2C, img_hw, scale=0.15):
    """5 corner points of a frustum in world coords."""
    H, W = img_hw
    R = np.asarray(W2C)[:, :3]
    t = np.asarray(W2C)[:, 3]
    c = -R.T @ t
    Kinv = np.linalg.inv(np.asarray(K))
    corners_px = np.asarray([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]], float)
    rays = (corners_px @ Kinv.T) @ R
    pts = c[None] + rays * scale
    return c, pts


def render_turntable(run_dir: str, out_path: Optional[str] = None,
                     frames: int = 36, elev: float = 20.0,
                     max_points: int = 20000):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pcd_path = os.path.join(run_dir, "pointcloud.ply")
    cams_path = os.path.join(run_dir, "cameras.json")
    mesh_path = os.path.join(run_dir, "mesh", "high_res.ply")
    pts = read_ply(pcd_path)[0] if os.path.exists(pcd_path) else None
    mesh_v = read_ply(mesh_path)[0] if os.path.exists(mesh_path) else None
    cams = json.load(open(cams_path)) if os.path.exists(cams_path) else []

    if pts is not None and len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(len(pts), max_points,
                                                  replace=False)]
    if mesh_v is not None and len(mesh_v) > max_points:
        mesh_v = mesh_v[np.random.default_rng(1).choice(len(mesh_v), max_points,
                                                        replace=False)]
    images = []
    for fi in range(frames):
        fig = plt.figure(figsize=(5, 5), dpi=80)
        ax = fig.add_subplot(111, projection="3d")
        if mesh_v is not None:
            ax.scatter(mesh_v[:, 0], mesh_v[:, 1], mesh_v[:, 2], s=0.3,
                       c="#b0c4de", alpha=0.35, linewidths=0)
        if pts is not None:
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1.5, c="#1f4e79",
                       linewidths=0)
        for cam in cams:
            c, corners = camera_frustum_lines(cam["K"], cam["W2C"],
                                              cam["img_size"])
            for p in corners:
                ax.plot([c[0], p[0]], [c[1], p[1]], [c[2], p[2]],
                        c="#c0392b", lw=0.7)
            loop = np.vstack([corners, corners[:1]])
            ax.plot(loop[:, 0], loop[:, 1], loop[:, 2], c="#c0392b", lw=0.7)
        ax.view_init(elev=elev, azim=360.0 * fi / frames)
        ax.set_axis_off()
        all_pts = [a for a in (pts, mesh_v) if a is not None]
        if all_pts:
            allc = np.concatenate(all_pts)
            mid = allc.mean(0)
            rad = np.abs(allc - mid).max() * 1.2 + 1e-6
            ax.set_xlim(mid[0] - rad, mid[0] + rad)
            ax.set_ylim(mid[1] - rad, mid[1] + rad)
            ax.set_zlim(mid[2] - rad, mid[2] + rad)
        fig.tight_layout(pad=0)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        images.append(buf.copy())
        plt.close(fig)

    if out_path:
        if out_path.endswith(".gif"):
            import imageio.v2 as imageio
            imageio.mimsave(out_path, images, fps=12, loop=0)
        else:
            os.makedirs(out_path, exist_ok=True)
            for i, im in enumerate(images):
                png.write_png(os.path.join(out_path, f"{i:03d}.png"), im)
    return images


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True, help="run output dir")
    ap.add_argument("--out", default=None, help=".gif path or frame dir")
    ap.add_argument("--frames", type=int, default=36)
    args = ap.parse_args()
    out = args.out or os.path.join(args.run, "replay.gif")
    render_turntable(args.run, out, frames=args.frames)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
