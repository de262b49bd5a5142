"""VolSDF volumetric renderer in PyTorch.

Counterpart of ``level_s2fm_tpu/rendering/renderer.py``: uniform mid-bin
depth sampling between ray–AABB hits, SDF + feature + analytic normal
eval, Laplace-CDF density and quadrature compositing with background
blending. With an occupancy grid and ``compact_samples`` set (the default
config), the fields are evaluated only on the first K samples inside the
occupancy band and composited by the fused CUDA kernels
(``fused_composite``). With ``volsdf_sampling`` the uniform samples are
refined by the JAX package's fixed-iteration VolSDF error-bound
up-sampling (``max_upsample_iter`` rounds of ``sample_intvs`` new depths
from the error bound's inverse CDF, then ``final_sample_intvs`` depths
from the opacity CDF, sorted together with the uniform ones). Under
``dual_field`` the second geometry feature joins the decoder's input.

``ray_chunk`` splits large batches into chunks exactly as the JAX
package does, so results stay identical; chunks are not rematerialized.

The differentiable gathers along the sample axis (the occupancy
compaction's, the adaptive sampler's) are ``take_along_last``, whose
gradient is summed in a fixed order on the card (``fields/hash_scatter``);
``torch.gather``'s backward would add with float atomics there. The
gathers left as ``torch.gather`` take a permutation, one contribution a
slot, which any order sums exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..fields import radiance as radf
from ..fields.hash_scatter import take_along_last
from ..fields import sdf as sdf_mod
from . import aabb as aabb_mod
from . import fused_composite as fc
from ..utils import obs


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    sample_intvs: int = 128
    final_sample_intvs: int = 64
    volsdf_sampling: bool = False
    max_upsample_iter: int = 6
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
        final_sample_intvs=int(opt.SDF.VolSDF.final_sample_intvs),
        volsdf_sampling=bool(opt.SDF.VolSDF.volsdf_sampling),
        max_upsample_iter=int(opt.SDF.VolSDF.max_upsample_iter),
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


def _r_t(d_vals, sdf, alpha, beta):
    """The Laplace density's optical depth before each interval [...,N-1]
    and the intervals [...,N-1]."""
    sigma = sdf_to_sigma(sdf, alpha, beta)
    delta = d_vals[..., 1:] - d_vals[..., :-1]
    zeros = torch.zeros_like(sdf[..., :1])
    R_t = torch.cat([zeros, torch.cumsum(sigma[..., :-1] * delta, dim=-1)],
                    dim=-1)[..., :-1]
    return R_t, delta


def error_bound(d_vals, sdf, alpha, beta):
    """VolSDF's bound on the opacity approximation error per interval;
    NaN and inf become the largest float, as ``jnp.nan_to_num`` maps
    them."""
    R_t, delta = _r_t(d_vals, sdf, alpha, beta)
    sdf_abs = torch.abs(sdf)
    d_star = torch.clamp(0.5 * (sdf_abs[..., :-1] + sdf_abs[..., 1:] - delta),
                         min=0.0)
    errors = alpha / (4 * beta) * delta ** 2 * torch.exp(-d_star / beta)
    bounds = torch.exp(-R_t) * (torch.exp(torch.cumsum(errors, dim=-1)) - 1.0)
    big = torch.finfo(bounds.dtype).max
    return torch.nan_to_num(bounds, nan=big, posinf=big)


def _search_left(a, v):
    """searchsorted(side='left') of v [...,M] in the ascending last axis
    of a [...,N]: the count of entries of a below each v."""
    return torch.searchsorted(a.contiguous(), v.contiguous(), side="left")


def sample_pdf(bins, weights, n_importance: int, eps: float = 1e-5):
    """Deterministic inverse-CDF sampling of ``n_importance`` depths."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    u = torch.linspace(0.0, 1.0, n_importance, dtype=cdf.dtype, device=cdf.device)
    u = u.expand(*cdf.shape[:-1], n_importance)
    inds = _search_left(cdf, u)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0 = take_along_last(cdf, below)
    cdf_g1 = take_along_last(cdf, above)
    nb = bins.shape[-1] - 1
    bins_g0 = take_along_last(bins, torch.clamp(below, max=nb))
    bins_g1 = take_along_last(bins, torch.clamp(above, max=nb))
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, 1.0, denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def opacity_to_sample(d_vals, sdf, alpha, beta, n_final: int):
    """``n_final`` depths from the inverse of the approximate opacity CDF."""
    R_t, _ = _r_t(d_vals, sdf, alpha, beta)
    opacity = 1 - torch.exp(-R_t)
    opacity = torch.cat([torch.zeros_like(opacity[..., :1]), opacity], -1)
    grid = torch.linspace(0, 1, n_final + 1, dtype=d_vals.dtype,
                          device=d_vals.device)
    unif = (0.5 * (grid[:-1] + grid[1:])).expand(*opacity.shape[:-1], n_final)
    idx = _search_left(opacity, unif)
    lo = torch.clamp(idx - 1, min=0)
    hi = torch.clamp(idx, max=opacity.shape[-1] - 1)
    nd = d_vals.shape[-1] - 1
    d_lo = take_along_last(d_vals, torch.clamp(lo, max=nd))
    d_hi = take_along_last(d_vals, torch.clamp(hi, max=nd))
    c_lo = take_along_last(opacity, lo)
    c_hi = take_along_last(opacity, hi)
    t = (unif - c_lo) / (c_hi - c_lo + 1e-8)
    return d_lo + t * (d_hi - d_lo)


def volsdf_sampling(sdf_params, sdf_cfg: sdf_mod.SDFConfig, cfg: RendererConfig,
                    center, ray):
    """Depth samples [B,HW,S]: uniform between the ray–AABB hits, or with
    ``cfg.volsdf_sampling`` the adaptive ones (S = final_sample_intvs +
    sample_intvs, sorted). The SDF values that steer the adaptive
    samples are detached; the depths stay differentiable w.r.t. alpha,
    beta and the rays, as in the JAX package."""
    B, HW = center.shape[0], center.shape[1]
    dev, dt = center.device, center.dtype
    t_near, t_far, _ = aabb_mod.ray_aabb_intersect(
        center.reshape(-1, 3), ray.reshape(-1, 3),
        torch.as_tensor(sdf_cfg.center, dtype=dt, device=dev),
        torch.as_tensor(sdf_cfg.half_size, dtype=dt, device=dev))
    min_d = t_near.reshape(B, HW, 1)
    max_d = t_far.reshape(B, HW, 1)
    depth_coarse = sample_depth(min_d, max_d, cfg.sample_intvs)[..., 0]
    if not cfg.volsdf_sampling:
        return depth_coarse

    def sdf_along(d):
        pts = center[..., None, :] + ray[..., None, :] * d[..., None]
        with torch.no_grad():
            return sdf_mod.infer_sdf(sdf_params, sdf_cfg, pts)[..., 0]

    alpha_g, beta_g = sdf_mod.forward_ab(sdf_params, sdf_cfg)
    d_vals = depth_coarse
    sdf = sdf_along(d_vals)
    for _ in range(cfg.max_upsample_iter):
        bounds = error_bound(d_vals, sdf, alpha_g, beta_g)
        new_d = sample_pdf(0.5 * (d_vals[..., 1:] + d_vals[..., :-1]), bounds,
                           cfg.sample_intvs + 2)[..., 1:-1]
        new_sdf = sdf_along(new_d)
        d_vals, order = torch.sort(torch.cat([d_vals, new_d], dim=-1), dim=-1,
                                   stable=True)
        sdf = torch.gather(torch.cat([sdf, new_sdf], dim=-1), -1, order)
    fine = opacity_to_sample(d_vals, sdf, alpha_g, beta_g, cfg.final_sample_intvs)
    # stable, as the JAX package's sort: tied depths keep their order, and
    # with it the gradient each one carries
    return torch.sort(torch.cat([fine, depth_coarse], dim=-1), dim=-1,
                      stable=True).values


@obs.traced("render")
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
    d_sel = take_along_last(depths, idx)
    return d_sel, v_sel


def _render_impl(sdf_params, sdf_cfg: sdf_mod.SDFConfig,
                 rad_params, rad_cfg: radf.RadFConfig,
                 cfg: RendererConfig, center, ray,
                 occ_grid=None) -> Dict[str, torch.Tensor]:
    depth_all = volsdf_sampling(sdf_params, sdf_cfg, cfg, center, ray)
    sample_valid = None
    if occ_grid is not None and cfg.compact_samples is not None:
        # the uniform bin width; under volsdf_sampling the sorted depths
        # are not uniform, and the JAX package takes the first gap all
        # the same (kept for parity)
        bin_w = depth_all[..., 1] - depth_all[..., 0]
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
    geo_enc = feats[..., 1:]
    if rad_cfg.dual_field:
        geo_enc = torch.cat(
            [geo_enc, radf.geometry_feat(rad_params, rad_cfg, p3d)[..., 1:]], dim=-1)
    all_enc = torch.cat([p3d, normals, ray_enc, geo_enc], dim=-1)
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
