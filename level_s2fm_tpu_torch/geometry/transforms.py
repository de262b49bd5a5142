"""Coordinate transforms and ray generation in PyTorch.

Counterpart of the part of ``level_s2fm_tpu/geometry/transforms.py`` that
the SfM pipeline uses: world/cam/img transforms, the pixel grid, camera
centres and rays, projection, and the Procrustes sim(3) alignment with
the camera-pose evaluation (an SVD on the host), and the novel-view
trajectory of the result export. NDC rays wait with the renderer's
extras.
"""
from __future__ import annotations

from typing import NamedTuple

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


class Sim3(NamedTuple):
    t0: torch.Tensor
    t1: torch.Tensor
    s0: torch.Tensor
    s1: torch.Tensor
    R: torch.Tensor


def procrustes_analysis(X0, X1):
    """Similarity transform aligning X1 to X0 (both [N,3]):
    X1to0 = (X1-t1)/s1 @ R.T * s0 + t0.

    R = U Vt is unchanged when an SVD flips the signs of a pair of
    singular vectors, so it does not depend on the library's sign
    convention (the singular values of a camera layout are distinct)."""
    t0 = X0.mean(dim=0, keepdim=True)
    t1 = X1.mean(dim=0, keepdim=True)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = torch.sqrt((X0c ** 2).sum(dim=-1).mean())
    s1 = torch.sqrt((X1c ** 2).sum(dim=-1).mean())
    U, _, Vt = torch.linalg.svd((X0c / s0).T @ (X1c / s1))
    if torch.linalg.det(U @ Vt) < 0:
        U = U.clone()
        U[:, 2] = -U[:, 2]
    return Sim3(t0=t0[0], t1=t1[0], s0=s0, s1=s1, R=U @ Vt)


def prealign_cameras(pose, pose_GT):
    """Sim3-align predicted w2c poses to GT via the camera centres.
    Returns (pose_aligned, sim3)."""
    center = torch.zeros((1, 1, 3), dtype=pose.dtype, device=pose.device)
    center_pred = cam2world(center, pose)[:, 0]
    center_GT = cam2world(center, pose_GT)[:, 0]
    sim3 = procrustes_analysis(center_GT, center_pred)
    center_aligned = ((center_pred - sim3.t1) / sim3.s1 @ sim3.R.T * sim3.s0
                      + sim3.t0)
    R_aligned = pose[..., :3] @ sim3.R.T
    t_aligned = (-R_aligned @ center_aligned[..., None])[..., 0]
    return lie.pose_from_Rt(R_aligned, t_aligned), sim3


def evaluate_camera_alignment(pose_aligned, pose_GT):
    """Rotation (rad), translation-norm errors and ATE between c2w poses."""
    R_aligned, t_aligned = pose_aligned[..., :3], pose_aligned[..., 3:]
    R_GT, t_GT = pose_GT[..., :3], pose_GT[..., 3:]
    R_error = lie.rotation_distance(R_aligned, R_GT)
    t_error = torch.linalg.norm((t_aligned - t_GT)[..., 0], dim=-1)
    ate = torch.sqrt(((t_aligned - t_GT)[..., 0] ** 2).sum(dim=-1).mean())
    return R_error, t_error, ate


def get_novel_view_poses(pose_anchor, N=60, scale=1.0):
    """Circular oscillating novel-view trajectory around a w2c pose
    [3,4]: N poses [N,3,4]."""
    theta = torch.arange(N, dtype=torch.float32) / N * 2 * torch.pi
    R_x = lie.angle_to_rotation_matrix(torch.arcsin(torch.sin(theta) * 0.008), "X")
    R_y = lie.angle_to_rotation_matrix(torch.arcsin(torch.cos(theta) * 0.008), "Y")
    pose_rot = lie.pose_from_Rt(R=R_y @ R_x)
    pose_shift = lie.pose_from_Rt(t=torch.tensor([0.0, 0.0, -0.5 * scale]))
    pose_shift2 = lie.pose_from_Rt(t=torch.tensor([0.0, 0.0, 0.2 * scale]))
    pose_oscil = lie.pose_compose([pose_shift, pose_rot, pose_shift2])
    return lie.pose_compose([pose_oscil, torch.as_tensor(pose_anchor,
                                                         dtype=torch.float32)[None]])
