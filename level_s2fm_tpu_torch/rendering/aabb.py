"""Ray–AABB intersection (slab method), vectorized.

Counterpart of ``level_s2fm_tpu/rendering/aabb.py::ray_aabb_intersect``.
"""
from __future__ import annotations

import torch


def ray_aabb_intersect(rays_o, rays_d, center, half_size, eps=1e-10):
    """Slab-method intersection with one axis-aligned box.

    rays_o/rays_d: [N,3]; center/half_size: [3].
    Returns (t_near [N], t_far [N], valid [N] bool). For missed rays both
    t's are -1. t_near is clamped to >= 0.
    """
    small = torch.abs(rays_d) < eps
    safe = torch.where(small, torch.where(rays_d >= 0, eps, -eps), rays_d)
    inv_d = 1.0 / safe
    lo = (center - half_size - rays_o) * inv_d
    hi = (center + half_size - rays_o) * inv_d
    t1 = torch.minimum(lo, hi).amax(dim=-1)
    t2 = torch.maximum(lo, hi).amin(dim=-1)
    t1 = torch.clamp(t1, min=0.0)
    valid = t2 > t1
    t_near = torch.where(valid, t1, -1.0)
    t_far = torch.where(valid, t2, -1.0)
    return t_near, t_far, valid
