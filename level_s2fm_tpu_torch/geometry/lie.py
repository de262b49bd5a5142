"""Lie-group camera pose math in PyTorch.

Counterpart of ``level_s2fm_tpu/geometry/lie.py`` for what the SfM
pipeline and ``CameraSet.eval_poses`` use: [R|t] composition and
inversion, the se3/SO3 exp/log maps with their small-angle branches
(``torch.where`` on a substituted operand, so gradients stay finite at
0), Euler rotations, the pose-error measures, quaternions (w, x, y, z) and
``slerp_pose``. Batched over leading dims.
"""
from __future__ import annotations

import math

import torch


def pose_from_Rt(R=None, t=None):
    """Build [...,3,4] pose from R [...,3,3] and/or t [...,3]."""
    if R is None:
        t = torch.as_tensor(t, dtype=torch.float32)
        R = torch.eye(3, dtype=t.dtype, device=t.device).expand(*t.shape[:-1], 3, 3)
    elif t is None:
        R = torch.as_tensor(R, dtype=torch.float32)
        t = torch.zeros(R.shape[:-1], dtype=R.dtype, device=R.device)
    return torch.cat([R, t[..., None]], dim=-1)


def pose_invert(pose):
    """Invert a [...,3,4] rigid pose (R orthonormal)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    t_inv = -(R_inv @ t)[..., 0]
    return pose_from_Rt(R_inv, t_inv)


def pose_compose_pair(pose_a, pose_b):
    """pose_new(x) = pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    R_new = R_b @ R_a
    t_new = (R_b @ t_a + t_b)[..., 0]
    return pose_from_Rt(R_new, t_new)


def pose_compose(pose_list):
    """pose_list[-1](...(pose_list[0](x)))."""
    p = pose_list[0]
    for q in pose_list[1:]:
        p = pose_compose_pair(p, q)
    return p


def skew(w):
    """[...,3] -> [...,3,3] skew-symmetric matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    O = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([O, -w2, w1], dim=-1),
        torch.stack([w2, O, -w0], dim=-1),
        torch.stack([-w1, w0, O], dim=-1),
    ], dim=-2)


# A = sin(x)/x, B = (1-cos x)/x^2, C = (x-sin x)/x^3, with a
# where-protected small-angle series below _SMALL.
_SMALL = 1e-4


def _sinc(x):
    small = torch.abs(x) < _SMALL
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(safe) / safe)


def _cosc(x):
    small = torch.abs(x) < _SMALL
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 0.5 - x * x / 24.0,
                       (1.0 - torch.cos(safe)) / (safe * safe))


def _sinc3(x):
    small = torch.abs(x) < _SMALL
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 / 6.0 - x * x / 120.0,
                       (safe - torch.sin(safe)) / (safe * safe * safe))


def _eye(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_to_SO3(w):
    """Exponential map so(3) [...,3] -> SO(3) [...,3,3] (Rodrigues)."""
    wx = skew(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    return _eye(w) + _sinc(theta) * wx + _cosc(theta) * (wx @ wx)


def SO3_to_so3(R, eps=1e-7):
    """Log map SO(3) -> so(3): w = theta / (2 sin theta) * vee(R - R^T)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = 0.5 / torch.clamp(_sinc(theta), min=1e-8)
    return scale[..., None] * v


def se3_to_SE3(wu):
    """Exp map se(3) [...,6] (w|u) -> [...,3,4] pose: [exp(w) | V u]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    I = _eye(wu)
    R = I + _sinc(theta) * wx + _cosc(theta) * (wx @ wx)
    V = I + _cosc(theta) * wx + _sinc3(theta) * (wx @ wx)
    return torch.cat([R, V @ u[..., None]], dim=-1)


def SE3_to_se3(Rt, eps=1e-8):
    """Log map [...,3,4] pose -> se(3) [...,6] via the closed-form
    V^-1 = I - wx/2 + (1 - A/(2B)) / theta^2 * wx^2."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    coef = (1 - _sinc(theta) / (2 * _cosc(theta))) / (theta ** 2 + eps)
    invV = _eye(Rt) - 0.5 * wx + coef * (wx @ wx)
    u = (invV @ t)[..., 0]
    return torch.cat([w, u], dim=-1)


# ----------------------------------------------------------------------------- quaternions

def q_to_R(q):
    """Quaternion (w,x,y,z) [...,4] -> rotation matrix [...,3,3]."""
    qa, qb, qc, qd = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (qc ** 2 + qd ** 2), 2 * (qb * qc - qa * qd),
                     2 * (qa * qc + qb * qd)], dim=-1),
        torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb ** 2 + qd ** 2),
                     2 * (qc * qd - qa * qb)], dim=-1),
        torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd),
                     1 - 2 * (qb ** 2 + qc ** 2)], dim=-1),
    ], dim=-2)


def R_to_q(R, eps=1e-8):
    """Rotation matrix -> quaternion (w,x,y,z); principal branch."""
    R00, R11, R22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    t = R00 + R11 + R22
    qa = 0.5 * torch.sqrt(torch.clamp(1 + t, min=eps))
    qb = torch.sign(R[..., 2, 1] - R[..., 1, 2]) * 0.5 * torch.sqrt(
        torch.clamp(1 + R00 - R11 - R22, min=eps))
    qc = torch.sign(R[..., 0, 2] - R[..., 2, 0]) * 0.5 * torch.sqrt(
        torch.clamp(1 - R00 + R11 - R22, min=eps))
    qd = torch.sign(R[..., 1, 0] - R[..., 0, 1]) * 0.5 * torch.sqrt(
        torch.clamp(1 - R00 - R11 + R22, min=eps))
    return torch.stack([qa, qb, qc, qd], dim=-1)


def q_invert(q):
    qa, qb, qc, qd = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    norm2 = torch.sum(q * q, dim=-1, keepdim=True)
    return torch.stack([qa, -qb, -qc, -qd], dim=-1) / norm2


def q_product(q1, q2):
    a1, b1, c1, d1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    a2, b2, c2, d2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
        a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
        a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
        a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
    ], dim=-1)


def slerp_pose(pose0, pose1, t: float):
    """Spherical interpolation of the rotations and linear interpolation
    of the translations of two [3,4] poses."""
    q0 = R_to_q(pose0[:3, :3])
    q1 = R_to_q(pose1[:3, :3])
    dot = torch.sum(q0 * q1)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    big = sin_theta > 1e-6
    den = torch.clamp(sin_theta, min=1e-12)
    w0 = torch.where(big, torch.sin((1 - t) * theta) / den, 1 - t)
    w1 = torch.where(big, torch.sin(t * theta) / den, t)
    q = w0 * q0 + w1 * q1
    q = q / torch.linalg.norm(q)
    T = (1 - t) * pose0[:3, 3] + t * pose1[:3, 3]
    return torch.cat([q_to_R(q), T[:, None]], dim=1)


def angle_to_rotation_matrix(a, axis: str):
    """Euler-angle rotation about axis 'X'|'Y'|'Z'."""
    a = torch.as_tensor(a, dtype=torch.float32)
    roll = dict(X=1, Y=2, Z=0)[axis]
    O = torch.zeros_like(a)
    I = torch.ones_like(a)
    M = torch.stack([
        torch.stack([torch.cos(a), -torch.sin(a), O], dim=-1),
        torch.stack([torch.sin(a), torch.cos(a), O], dim=-1),
        torch.stack([O, O, I], dim=-1),
    ], dim=-2)
    return torch.roll(M, shifts=(roll, roll), dims=(-2, -1))


def rotation_distance(R1, R2, eps=1e-7):
    """Geodesic angle between rotations (radians)."""
    R_diff = R1 @ R2.transpose(-2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))


def translation_angle_deg(t1, t2):
    """Angle (deg) between two translation directions."""
    cosang = torch.sum(t1 * t2) / (torch.linalg.norm(t1) * torch.linalg.norm(t2))
    return torch.arccos(torch.clamp(cosang, -1.0, 1.0)) / math.pi * 180.0
