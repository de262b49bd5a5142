"""Occupancy grid for occupancy-compacted rendering.

Counterpart of ``OccupancyGrid`` / ``build_occupancy_grid`` in
``level_s2fm_tpu/rendering/raymarch.py``. The ray marcher, hard-stop
compositing and ``trunc_exp`` of that module are off the main path and
wait.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
