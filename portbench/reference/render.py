"""Plain PyTorch rays, occupancy grid, volume render and the shared
render loss bundle of the port's phases (``render_core``).

The render: 128 mid-bin depths between the ray-box hits, the first K of
them inside the occupancy band (the grid's cells where the SDF is under
the threshold), the SDF, feature and analytic normal at each, the
radiance MLP, and the Laplace-density quadrature composite written out
as tensor operations. The composite's gradients come from autograd.
"""
from __future__ import annotations

import torch

from . import field

EPS = 1e-6


# --------------------------------------------------------------------------- cameras

def mesh_grid(H, W, device=None):
    """Pixel centres [HW,2] in (x, y) order."""
    y = torch.arange(H, dtype=torch.float32, device=device) + 0.5
    x = torch.arange(W, dtype=torch.float32, device=device) + 0.5
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y], -1).reshape(-1, 2)


def _hom(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _cam2world(x, pose):
    R, t = pose[..., :3], pose[..., 3:]
    Ri = R.transpose(-1, -2)
    inv = torch.cat([Ri, (-(Ri @ t)[..., 0])[..., None]], -1)
    return _hom(x) @ inv.transpose(-1, -2)


def center_and_ray(pose, K, xy):
    """World camera centres and ray directions [B,N,3] through pixels xy
    [N,2] of cameras pose [B,3,4] (world to camera)."""
    B = pose.shape[0]
    g = _hom(xy[None].expand(B, *xy.shape)) @ torch.linalg.inv(K[None]).transpose(-1, -2)
    c = _cam2world(torch.zeros_like(g), pose)
    return c, _cam2world(g, pose) - c


def project(pts, pose, K, eps=EPS):
    """Pixels of world points pts [...,N,3] under pose [...,3,4]."""
    uvw = (_hom(pts) @ pose.transpose(-1, -2)) @ K.transpose(-1, -2)
    z = uvw[..., 2:]
    den = torch.where(z >= 0, torch.clamp(z, min=eps), torch.clamp(z, max=-eps))
    return uvw[..., :2] / den


def project_each(pts, poses, K, eps=EPS):
    """Pixels of points pts [P,3], each under its own pose [P,3,4]."""
    xc = torch.einsum("pij,pj->pi", poses, _hom(pts))
    uvw = xc @ K.T
    z = uvw[..., 2]
    den = torch.where(z >= 0, torch.clamp(z, min=eps), torch.clamp(z, max=-eps))
    return uvw[..., :2] / den[..., None]


# --------------------------------------------------------------------------- losses

def safe_norm(x, dim=-1, eps=1e-12):
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def masked_mean(x, mask, eps=1e-8):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / (torch.sum(m) + eps)


def smooth_l1(x, y):
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def weighted_total(loss, weights):
    total = 0.0
    for k, v in loss.items():
        if weights.get(k) is not None:
            total = total + 10.0 ** weights[k] * v
    return total


# --------------------------------------------------------------------------- render

@torch.no_grad()
def occupancy(params, cfg, device):
    """[G,G,G] bool: cell centres whose SDF is under the threshold."""
    G = cfg["occ_res"]
    bmin = torch.as_tensor(cfg["bmin"], dtype=torch.float32, device=device)
    bmax = torch.as_tensor(cfg["bmax"], dtype=torch.float32, device=device)
    c, h = (bmax + bmin) / 2, (bmax - bmin) / 2
    g = (torch.arange(G, device=device) + 0.5) / G * 2.0 - 1.0
    pts = (torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1) * h + c).reshape(-1, 3)
    s = torch.cat([field.sdf(params, cfg, pts[i:i + 131072])
                   for i in range(0, pts.shape[0], 131072)])
    return s.reshape(G, G, G) < cfg["occ_threshold"]


def _render_rays(sdf_p, rad_p, cfg, center, ray, occ):
    """center, ray [B,R,3] -> rgb [B,R,3], depth [B,R,1], normals
    [B,R,K,3]."""
    B, R = center.shape[:2]
    t0, t1, _ = field.ray_box(center.reshape(-1, 3), ray.reshape(-1, 3), cfg)
    t0, t1 = t0.reshape(B, R, 1), t1.reshape(B, R, 1)
    n = cfg["sample_intvs"]
    u = 0.5 + torch.arange(n, dtype=center.dtype, device=center.device)
    depths = (u[None, None, :, None] / n * (t1[..., None, :] - t0[..., None, :])
              + t0[..., None, :])[..., 0]                        # [B,R,S]
    bin_w = depths[..., 1] - depths[..., 0]
    # the first K depths inside the occupancy band
    G = occ.shape[0]
    bmin = torch.as_tensor(cfg["bmin"], dtype=center.dtype, device=center.device)
    bmax = torch.as_tensor(cfg["bmax"], dtype=center.dtype, device=center.device)
    pts = center[..., None, :] + ray[..., None, :] * depths[..., None]
    rel = (pts - (bmax + bmin) / 2) / (2 * ((bmax - bmin) / 2)) + 0.5
    cell = torch.clamp((rel * G).to(torch.int64), 0, G - 1)
    inside = occ[cell[..., 0], cell[..., 1], cell[..., 2]]
    cum = torch.cumsum(inside.to(torch.int32), -1)
    K = cfg["compact"]
    ks = torch.arange(1, K + 1, dtype=torch.int32, device=center.device)
    idx = torch.searchsorted(cum, ks.expand(*cum.shape[:-1], K).contiguous())
    valid = ks <= cum[..., -1:]
    d = torch.gather(depths, -1, torch.clamp(idx, max=n - 1))     # [B,R,K]
    p3d = center[..., None, :] + ray[..., None, :] * d[..., None]
    alpha, beta = field.alpha_beta(sdf_p, cfg)
    sdfs, feats, normals = field.sdf_feat_normal(sdf_p, cfg, p3d)
    view = ray[..., None, :].expand(p3d.shape)
    enc = torch.cat([p3d, normals, field.fourier(view), feats[..., 1:]], -1)
    rgbs = field.radiance_mlp(rad_p["rad_mlp"], enc)
    # Laplace density and quadrature: s_k = sigma_k * delta, w_k = T_k (1 - e^-s_k)
    delta = torch.linalg.norm(ray, dim=-1) * bin_w
    e = 0.5 * torch.exp(-torch.abs(sdfs) / beta[0])
    sigma = alpha[0] * torch.where(sdfs >= 0, e, 1.0 - e) * valid.to(sdfs.dtype)
    s = sigma * delta[..., None]
    w = torch.exp(-(torch.cumsum(s, -1) - s)) * (1.0 - torch.exp(-s))
    op = torch.sum(w, -1)[..., None]
    bg = torch.as_tensor(cfg["bgcolor"], dtype=rgbs.dtype, device=rgbs.device)
    rgb = torch.einsum("...k,...kc->...c", w, rgbs) + (1 - op) * bg
    depth = torch.sum(w * d, -1)[..., None] + (1 - op) * d[..., -1:]
    return rgb, depth, normals


def render(params, cfg, center, ray, occ):
    """The render in chunks of ``ray_chunk`` rays along the ray axis
    (the last ray repeated to fill the last chunk)."""
    R, ch = center.shape[1], cfg["ray_chunk"]
    if R <= ch:
        return _render_rays(params["sdf"], params["rad"], cfg, center, ray, occ)
    pad = (-R) % ch
    if pad:
        center = torch.cat([center, center[:, -1:].expand(-1, pad, -1)], 1)
        ray = torch.cat([ray, ray[:, -1:].expand(-1, pad, -1)], 1)
    outs = [_render_rays(params["sdf"], params["rad"], cfg, center[:, i:i + ch],
                         ray[:, i:i + ch], occ) for i in range(0, R + pad, ch)]
    return tuple(torch.cat([o[j] for o in outs], 1)[:, :R] for j in range(3))


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return [_detach(v) for v in tree]


def render_core(params, cfg, gen, poses, K, images, grid, occ, tracing=None,
                cam_mask=None, n_real=None, dc_frozen=False):
    """Random rays of every camera, one march for them and the tracked
    keypoints' rays, the render and the losses on them (the port's
    ``render_core`` at one rank). The draws: the rays, then the tracing
    camera."""
    C = poses.shape[0]
    n_rays = min(max(cfg["rand_rays"] // C, 1), grid.shape[0])
    rays_idx = torch.randperm(grid.shape[0], generator=gen)[:n_rays].to(poses.device)
    center, ray = center_and_ray(poses, K, grid[rays_idx])
    gt = images[:, rays_idx]
    fc, fr = center.reshape(-1, 3), ray.reshape(-1, 3)
    n_dc = fc.shape[0]
    out = {}
    if tracing is not None:
        j = int(torch.randint(0, C if n_real is None else n_real, (), generator=gen))
        tc, tr = tracing["center"][j], tracing["ray"][j]
        m = field.march(params["sdf"], cfg, torch.cat([fc, tc]), torch.cat([fr, tr]))
        m_tr = {"track": m["track"][:, n_dc:], "t0": m["t0"][n_dc:],
                "t1": m["t1"][n_dc:], "hit": m["hit"][n_dc:]}
        _, last, _, surf = field.reeval(params["sdf"], cfg, m_tr, tc, tr)
        out["tracing_loss"] = masked_mean(safe_norm(tracing["xyz"][j] - surf),
                                          tracing["mask"][j])
        out["sdfs_traced"], out["tmask"] = last, tracing["mask"][j]
    else:
        m = field.march(params["sdf"], cfg, fc, fr)
    rgb, depth, normals = render(params, cfg, center, ray, occ)
    m_dc = {"track": m["track"][:, :n_dc], "t0": m["t0"][:n_dc],
            "t1": m["t1"][:n_dc], "hit": m["hit"][:n_dc]}
    sdf_p = _detach(params["sdf"]) if dc_frozen else params["sdf"]
    d_dc, _, fin, _ = field.reeval(sdf_p, cfg, m_dc, fc, fr)
    mean_gt = gt.mean(-1)
    real = (torch.ones((C, n_rays), dtype=torch.bool, device=poses.device)
            if cam_mask is None else cam_mask[:, None].expand(C, n_rays))
    mask_bg = (mean_gt < 0.95) & (mean_gt > 0.05) & real
    mask_fin = fin.reshape(C, n_rays) & mask_bg
    dc = masked_mean(smooth_l1(d_dc.reshape(C, n_rays), depth[..., 0]), mask_fin)
    out["DC_loss"] = torch.where(mask_fin.to(torch.float32).sum() > 0, dc,
                                 torch.zeros_like(dc))
    out["rgb_loss"] = (torch.mean(torch.abs(rgb - gt)) if cam_mask is None else
                       masked_mean(torch.abs(rgb - gt).mean(-1), real))
    out.update(normals=normals, mask_bg=mask_bg, ray_real=real)
    return out


def eikonal(normals, mask=None):
    """Mean | |n| - 1 | over the render's normals [C,R,K,3]; ``mask``
    [C,R] selects rays."""
    n = safe_norm(normals)
    if mask is None:
        return torch.mean(torch.abs(n - 1.0))
    return masked_mean(torch.abs(n - 1.0), mask[..., None].expand(n.shape))
