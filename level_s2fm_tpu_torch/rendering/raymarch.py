"""Occupancy grid, occupancy-grid ray marching and hard-stop compositing.

Counterpart of ``level_s2fm_tpu/rendering/raymarch.py``: the occupancy
grid that compacts the renderer's samples, and the parity module of the
reference's vren ray marcher and compositor (fixed samples per ray,
empty cells masked, transmittance early stop by masking), ``trunc_exp``
(exp with a clipped gradient) and ``segment_mean`` (summed in a fixed
order by the ordered scatter, on the card too).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..fields.hash_scatter import OrderedScatter
from . import aabb as aabb_mod


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, clip):
        ctx.save_for_backward(x)
        ctx.clip = clip
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -ctx.clip, ctx.clip)), None


def trunc_exp(x, clip: float = 15.0):
    """exp(x) whose gradient is exp(clip(x, -clip, clip))."""
    return _TruncExp.apply(x, clip)


class OccupancyGrid(NamedTuple):
    """Binary occupancy over a cubic grid inside the AABB."""
    occ: torch.Tensor          # [G,G,G] bool
    center: torch.Tensor       # [3]
    half_size: torch.Tensor    # [3]

    @property
    def resolution(self) -> int:
        return self.occ.shape[0]


@torch.no_grad()
def build_occupancy_grid(sdf_fn, center, half_size, resolution: int = 64,
                         threshold: float = 0.05, chunk: int = 131072,
                         one_sided: bool = False, device=None):
    """Occupancy from the SDF at cell centers.

    one_sided=False: |sdf| < threshold (surface band). one_sided=True:
    sdf < threshold (band + interior — the criterion for VolSDF
    compositing).
    """
    center = torch.as_tensor(center, dtype=torch.float32, device=device)
    half_size = torch.as_tensor(half_size, dtype=torch.float32, device=device)
    g = (torch.arange(resolution, device=center.device) + 0.5) / resolution * 2.0 - 1.0
    pts = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1)
    pts = pts * half_size + center
    flat = pts.reshape(-1, 3)
    vals = [sdf_fn(flat[i:i + chunk])[..., 0]
            for i in range(0, flat.shape[0], chunk)]
    sdf = torch.cat(vals).reshape(resolution, resolution, resolution)
    occ = (sdf < threshold) if one_sided else (torch.abs(sdf) < threshold)
    return OccupancyGrid(occ=occ, center=center, half_size=half_size)


def march_rays(grid: OccupancyGrid, rays_o, rays_d, n_samples: int = 128,
               perturb=None):
    """Sample depths along rays, masking samples in unoccupied cells.

    rays_o/rays_d [N,3]; ``perturb`` [N,S] uniform [0,1) draws jitter the
    samples within their bins. Returns (depths [N,S], deltas [N,S],
    valid [N,S]).
    """
    t0, t1, hit = aabb_mod.ray_aabb_intersect(rays_o, rays_d, grid.center,
                                              grid.half_size)
    u = (torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device)
         + 0.5) / n_samples
    if perturb is not None:
        u = u + (perturb - 0.5) / n_samples
    depths = t0[:, None] + u * (t1 - t0)[:, None]                  # [N,S]
    deltas = torch.gradient(depths, dim=1)[0]
    pts = rays_o[:, None, :] + depths[..., None] * rays_d[:, None, :]
    rel = (pts - grid.center) / (2 * grid.half_size) + 0.5
    cell = torch.clamp((rel * grid.resolution).to(torch.int64), 0,
                       grid.resolution - 1)
    occ = grid.occ[cell[..., 0], cell[..., 1], cell[..., 2]]
    return depths, deltas, occ & hit[:, None]


def composite_hard_stop(sigmas, rgbs, deltas, valid,
                        T_threshold: float = 1e-4,
                        bg_color: Optional[torch.Tensor] = None):
    """Front-to-back compositing; a sample contributes only while the
    transmittance before it is above ``T_threshold``.

    sigmas [N,S]; rgbs [N,S,3]; deltas [N,S]; valid [N,S].
    Returns dict(opacity [N], rgb [N,3], ws [N,S]).
    """
    sig = torch.where(valid, sigmas, 0.0)
    alpha = 1.0 - torch.exp(-sig * deltas)
    zeros = torch.zeros_like(alpha[:, :1])
    T = torch.exp(-torch.cumsum(torch.cat([zeros, sig * deltas], dim=1),
                                dim=1))[:, :-1]
    w = torch.where(T > T_threshold, T * alpha, 0.0)
    opacity = w.sum(dim=1)
    rgb = torch.sum(w[..., None] * rgbs, dim=1)
    if bg_color is not None:
        rgb = rgb + (1 - opacity)[:, None] * bg_color
    return {"opacity": opacity, "rgb": rgb, "ws": w}


def segment_mean(values, segment_ids, num_segments: int):
    """Mean of ``values`` [N] per segment id in [0, num_segments); an
    empty segment gives 0."""
    both = torch.stack([values, torch.ones_like(values)], dim=-1)
    s, c = OrderedScatter.apply(both, segment_ids, num_segments).unbind(-1)
    return s / torch.clamp(c, min=1.0)
