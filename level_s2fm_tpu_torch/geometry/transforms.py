"""Coordinate transforms and ray generation in PyTorch.

Counterpart of the part of ``level_s2fm_tpu/geometry/transforms.py`` that
two-view initialization uses: world/cam/img transforms, the pixel grid,
camera centres and rays, and projection. Procrustes alignment and the
multi-view evaluation wait for the registration slice.
"""
from __future__ import annotations

import torch

from . import lie


def to_hom(X):
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def world2cam(X, pose):
    """X [...,N,3], pose [...,3,4] (w2c) -> camera-frame points."""
    return to_hom(X) @ pose.transpose(-1, -2)


def cam2img(X, K):
    return X @ K.transpose(-1, -2)


def img2cam(X, K):
    return X @ torch.linalg.inv(K).transpose(-1, -2)


def cam2world(X, pose):
    pose_inv = lie.pose_invert(pose)
    return to_hom(X) @ pose_inv.transpose(-1, -2)


def mesh_grid(H: int, W: int, device=None):
    """Pixel-center grid [HW,2] in (x,y) order."""
    y = torch.arange(H, dtype=torch.float32, device=device) + 0.5
    x = torch.arange(W, dtype=torch.float32, device=device) + 0.5
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y], dim=-1).reshape(-1, 2)


def get_center_and_ray(pose, intr, xy_grid):
    """Camera centers + (unnormalized) ray directions in world frame.

    pose [B,3,4] w2c, intr [B,3,3] or [3,3], xy_grid [N,2] pixel coords.
    Returns center [B,N,3], ray [B,N,3]; point = center + d * ray where d
    is z-depth.
    """
    if intr.ndim == 2:
        intr = intr[None]
    B = pose.shape[0]
    grid = xy_grid[None].expand(B, *xy_grid.shape)
    grid_3D = img2cam(to_hom(grid), intr)
    center_3D = torch.zeros_like(grid_3D)
    grid_3D = cam2world(grid_3D, pose)
    center_3D = cam2world(center_3D, pose)
    return center_3D, grid_3D - center_3D


def project_points(pts, pose, K, eps=1e-6):
    """World points [...,N,3] -> pixel uv [...,N,2] and depth [...,N,1].

    The divisor is clamped away from zero on both sides.
    """
    Xc = world2cam(pts, pose)
    uvw = cam2img(Xc, K)
    depth = uvw[..., 2:]
    denom = torch.where(depth >= 0, torch.clamp(depth, min=eps),
                        torch.clamp(depth, max=-eps))
    uv = uvw[..., :2] / denom
    return uv, depth
