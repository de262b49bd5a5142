"""VolSDF volumetric renderer in PyTorch.

Counterpart of ``level_s2fm_tpu/rendering/renderer.py``: uniform mid-bin
depth sampling between ray–AABB hits, SDF + feature + analytic normal
eval, Laplace-CDF density and quadrature compositing with background
blending. With an occupancy grid and ``compact_samples`` set (the default
config), the fields are evaluated only on the first K samples inside the
occupancy band and composited by the fused CUDA kernels
(``fused_composite``). The adaptive ``volsdf_sampling`` path waits.

``ray_chunk`` splits large batches into chunks exactly as the JAX
package does, so results stay identical; chunks are not rematerialized.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..fields import radiance as radf
from ..fields import sdf as sdf_mod
from . import aabb as aabb_mod
from . import fused_composite as fc


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    sample_intvs: int = 128
    volsdf_sampling: bool = False
    bgcolor: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # process rays in chunks of this size along the ray axis; None = one pass
    ray_chunk: Optional[int] = 2048
    # occupancy-guided sample compaction: keep the first `compact_samples`
    # depth samples inside the occupancy band. None = all samples.
    compact_samples: Optional[int] = None
    # the fused composite on the compacted path. On CUDA tensors it is
    # always the kernel; False there raises instead of silently running
    # the plain version. On the CPU the plain version runs either way.
    fused_composite: Optional[bool] = None


def config_from_opt(opt) -> RendererConfig:
    from ..config import scene_opt
    bg = scene_opt(opt, "bgcolor", None) or opt.data.get("bgcolor") or (0.0, 0.0, 0.0)
    ren = opt.get("Renderer", {})
    return RendererConfig(
        sample_intvs=int(opt.SDF.VolSDF.sample_intvs),
        volsdf_sampling=bool(opt.SDF.VolSDF.volsdf_sampling),
        bgcolor=tuple(bg),
        ray_chunk=ren.get("ray_chunk", 2048),
        compact_samples=ren.get("compact_samples", None),
        fused_composite=ren.get("fused_composite", None),
    )


def sample_depth(min_d, max_d, n: int):
    """Deterministic mid-bin uniform depths. min_d/max_d: [B,HW,1] ->
    [B,HW,n,1]."""
    rand = 0.5 + torch.arange(n, dtype=min_d.dtype, device=min_d.device)[None, None, :, None]
    return rand / n * (max_d[..., None, :] - min_d[..., None, :]) + min_d[..., None, :]


def composite(ray, rgb_samples, density_samples, depth_samples):
    """Quadrature compositing over all samples (the uncompacted path).

    ray [B,HW,3]; rgb_samples [B,HW,N,3]; density [B,HW,N];
    depth_samples [B,HW,N,1]. Returns (rgb [B,HW,3], prob [B,HW,N-1,1]).
    """
    ray_length = torch.linalg.norm(ray, dim=-1, keepdim=True)
    depth_intv = depth_samples[..., 1:, 0] - depth_samples[..., :-1, 0]
    dist = depth_intv * ray_length
    sigma_delta = density_samples[..., :-1] * dist
    alpha = 1 - torch.exp(-sigma_delta)
    zeros = torch.zeros_like(sigma_delta[..., :1])
    T = torch.exp(-torch.cumsum(torch.cat([zeros, sigma_delta], dim=2), dim=2))[..., :-1]
    prob = (T * alpha)[..., None]
    rgb = torch.sum(rgb_samples[..., :-1, :] * prob, dim=2)
    return rgb, prob


def sdf_to_sigma(sdf, alpha, beta):
    e = 0.5 * torch.exp(-torch.abs(sdf) / beta)
    return alpha * torch.where(sdf >= 0, e, 1 - e)


def volsdf_sampling(sdf_params, sdf_cfg: sdf_mod.SDFConfig, cfg: RendererConfig,
                    center, ray):
    """Uniform depth samples between the ray–AABB hits: [B,HW,S]."""
    if cfg.volsdf_sampling:
        raise NotImplementedError(
            "SDF.VolSDF.volsdf_sampling=True (adaptive sampling) is not ported yet")
    B, HW = center.shape[0], center.shape[1]
    dev, dt = center.device, center.dtype
    t_near, t_far, _ = aabb_mod.ray_aabb_intersect(
        center.reshape(-1, 3), ray.reshape(-1, 3),
        torch.as_tensor(sdf_cfg.center, dtype=dt, device=dev),
        torch.as_tensor(sdf_cfg.half_size, dtype=dt, device=dev))
    min_d = t_near.reshape(B, HW, 1)
    max_d = t_far.reshape(B, HW, 1)
    return sample_depth(min_d, max_d, cfg.sample_intvs)[..., 0]


def render(sdf_params, sdf_cfg: sdf_mod.SDFConfig,
           rad_params, rad_cfg: radf.RadFConfig,
           cfg: RendererConfig, center, ray,
           occ_grid=None) -> Dict[str, torch.Tensor]:
    """Forward render of a ray batch. center/ray: [B,HW,3]. Returns dict
    with rgb, sdfs_volume, normals, depth_mlp, normal_mlp, opacity."""
    HW = center.shape[1]
    chunk = cfg.ray_chunk
    if chunk is not None and HW > chunk:
        pad = (-HW) % chunk
        if pad:
            center = torch.cat([center, center[:, -1:].expand(-1, pad, -1)], dim=1)
            ray = torch.cat([ray, ray[:, -1:].expand(-1, pad, -1)], dim=1)
        outs = [_render_impl(sdf_params, sdf_cfg, rad_params, rad_cfg, cfg,
                             center[:, i:i + chunk], ray[:, i:i + chunk],
                             occ_grid=occ_grid)
                for i in range(0, HW + pad, chunk)]
        return {k: torch.cat([o[k] for o in outs], dim=1)[:, :HW]
                for k in outs[0]}
    return _render_impl(sdf_params, sdf_cfg, rad_params, rad_cfg, cfg,
                        center, ray, occ_grid=occ_grid)


def compact_by_occupancy(depths, center, ray, occ_grid, K: int):
    """Keep the K nearest samples inside the occupancy band, depth-ordered.

    depths [B,HW,S], ascending along the sample axis. Returns (depths_sel
    [B,HW,K], valid_sel [B,HW,K]). The k-th valid sample is found by a
    search of k+1 in the running count of valid samples.
    """
    pts = center[..., None, :] + ray[..., None, :] * depths[..., None]
    rel = (pts - occ_grid.center) / (2 * occ_grid.half_size) + 0.5
    res = occ_grid.resolution
    cell = torch.clamp((rel * res).to(torch.int64), 0, res - 1)
    valid = occ_grid.occ[cell[..., 0], cell[..., 1], cell[..., 2]]
    cum = torch.cumsum(valid.to(torch.int32), dim=-1)           # [B,HW,S]
    ks = torch.arange(1, K + 1, dtype=torch.int32, device=depths.device)
    idx = torch.searchsorted(cum, ks.expand(*cum.shape[:-1], K).contiguous())
    v_sel = ks <= cum[..., -1:]
    idx = torch.clamp(idx, max=depths.shape[-1] - 1)
    d_sel = torch.take_along_dim(depths, idx, dim=-1)
    return d_sel, v_sel


def _render_impl(sdf_params, sdf_cfg: sdf_mod.SDFConfig,
                 rad_params, rad_cfg: radf.RadFConfig,
                 cfg: RendererConfig, center, ray,
                 occ_grid=None) -> Dict[str, torch.Tensor]:
    depth_all = volsdf_sampling(sdf_params, sdf_cfg, cfg, center, ray)
    sample_valid = None
    if occ_grid is not None and cfg.compact_samples is not None:
        bin_w = depth_all[..., 1] - depth_all[..., 0]     # uniform bin width
        d, sample_valid = compact_by_occupancy(
            depth_all, center, ray, occ_grid, int(cfg.compact_samples))
        depth_samples = d[..., None]
    else:
        depth_samples = depth_all[..., None]
    p3d = center[..., None, :] + ray[..., None, :] * depth_samples  # [B,HW,N,3]

    alpha_r, beta_r = sdf_mod.forward_ab(sdf_params, sdf_cfg)
    sdfs, feats, normals = sdf_mod.infer_all_with_normal(sdf_params, sdf_cfg, p3d)

    view = ray[..., None, :].expand(p3d.shape)
    ray_enc = radf.embed_view(rad_cfg, view)
    all_enc = torch.cat([p3d, normals, ray_enc, feats[..., 1:]], dim=-1)
    rgbs = radf.infer_app(rad_params, rad_cfg, all_enc)

    bg = torch.as_tensor(cfg.bgcolor, dtype=rgbs.dtype, device=rgbs.device)
    if sample_valid is not None:
        if center.is_cuda and cfg.fused_composite is False:
            raise ValueError("Renderer.fused_composite=false: the compacted "
                             "path on CUDA always runs the fused kernels")
        rgb_s, depth_mlp, normal_mlp, opacity = fc.composite_fused(
            ray, rgbs, sdfs[..., 0], sample_valid, bin_w,
            depth_samples[..., 0], normals, alpha_r[0], beta_r[0])
        rgb = rgb_s + (1 - opacity) * bg
        depth_mlp = depth_mlp + (1 - opacity) * depth_samples[..., -1, :]
        normal_mlp = normal_mlp + (1 - opacity) * normals[..., -1, :]
        return {"rgb": rgb, "sdfs_volume": sdfs, "normals": normals,
                "depth_mlp": depth_mlp, "normal_mlp": normal_mlp,
                "opacity": opacity}

    densities = sdf_to_sigma(sdfs, alpha_r, beta_r)
    rgb, prob = composite(ray, rgbs, densities[..., 0], depth_samples)
    opacity = torch.sum(prob, dim=2)
    rgb = rgb + (1 - opacity) * bg
    depth_mlp = torch.sum(depth_samples[..., :-1, :] * prob, dim=2)
    depth_mlp = depth_mlp + (1 - opacity) * depth_samples[..., -1, :]
    normal_mlp = torch.sum(normals[..., :-1, :] * prob, dim=2)
    normal_mlp = normal_mlp + (1 - opacity) * normals[..., -1, :]
    return {"rgb": rgb, "sdfs_volume": sdfs, "normals": normals,
            "depth_mlp": depth_mlp, "normal_mlp": normal_mlp, "opacity": opacity}
