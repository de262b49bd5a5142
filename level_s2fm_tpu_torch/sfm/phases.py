"""Optimization phases in PyTorch: the shared render core and two-view
initialization.

Counterpart of ``level_s2fm_tpu/sfm/phases.py`` (``render_core``,
``guarded_update``, ``eikonal_from_normals``, ``InitPhase``). A phase is
a Python loop over one step; the JAX package's scan chunking
(``chunked_run``, ``LS2FM_SCAN_CHUNK``) worked around TPU dispatch limits
and is not ported. GeoInit, BA and refine phases wait.

Randomness comes from a CPU ``torch.Generator`` passed by the caller;
``render_core`` also accepts its ray draw (``rays_idx``) as a tensor, so
tests can give both packages the same rays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..fields import radiance as radf
from ..fields import sdf as sdf_mod
from ..geometry import transforms as T
from ..rendering import renderer as ren_mod
from . import losses as L
from . import optim as optim_mod

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class PhaseCfgs:
    """Static configuration shared by all phases."""
    sdf: sdf_mod.SDFConfig
    rad: radf.RadFConfig
    ren: ren_mod.RendererConfig
    H: int
    W: int
    rand_rays: int = 8192
    dc_unfinish_weight: Optional[float] = None  # None: dataset in the ref's list


def project_points_per(pts, poses, K, eps=EPS):
    """Project per-element: pts [P,3], poses [P,3,4], K [3,3] -> uv [P,2],
    z [P]; the divisor is clamped away from zero on both sides."""
    Xh = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    Xc = torch.einsum("pij,pj->pi", poses, Xh)
    uvw = Xc @ K.T
    z = uvw[..., 2]
    denom = torch.where(z >= 0, torch.clamp(z, min=eps), torch.clamp(z, max=-eps))
    return uvw[..., :2] / denom[..., None], z


def _detach_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach_tree(v) for k, v in tree.items()}
    return [_detach_tree(v) for v in tree]


def render_core(params, cfgs: PhaseCfgs, gen: Optional[torch.Generator],
                poses, intr, images, grid, tracing=None, occ=None,
                dc_trace_frozen: bool = False, cam_mask=None, rays_idx=None):
    """Random-ray multi-view render + the standard loss bundle.

    poses [C,3,4]; intr [3,3]; images [C,HW,3]; grid [HW,2].
    tracing: optional dict of per-camera padded tracked-keypoint data
      {"center" [C,Nt,3], "ray" [C,Nt,3], "xyz" [C,Nt,3], "mask" [C,Nt]}
      for the multi-view sphere-trace consistency loss.
    ONE sphere march serves the DC-loss rays and the tracing rays.
    ``dc_trace_frozen`` re-evaluates the DC track with a frozen SDF.
    ``cam_mask`` [C] bool marks the real cameras of a padded camera axis.
    ``rays_idx`` [n_rays] replaces the random draw of the rays.
    Returns dict of losses/metrics plus 'normals', 'mask_bg'.
    """
    dev = poses.device
    C = poses.shape[0]
    HW = cfgs.H * cfgs.W
    n_rays = min(max(cfgs.rand_rays // C, 1), HW)
    if rays_idx is None:
        rays_idx = torch.randperm(HW, generator=gen)[:n_rays]
    rays_idx = torch.as_tensor(rays_idx, device=dev)
    n_rays = rays_idx.shape[0]
    centers, rays = T.get_center_and_ray(poses, intr, grid[rays_idx])  # [C,R,3]
    rgbs_gt = images[:, rays_idx]

    n_valid = C if cam_mask is None else cam_mask.sum()
    out = {}
    flat_c = centers.reshape(-1, 3)
    flat_r = rays.reshape(-1, 3)
    n_dc = flat_c.shape[0]
    if tracing is not None:
        nv = C if cam_mask is None else int(cam_mask.sum())
        cam_j = int(torch.randint(0, nv, (), generator=gen))
        tc = tracing["center"][cam_j]
        tray = tracing["ray"][cam_j]
        txyz = tracing["xyz"][cam_j]
        tmask = tracing["mask"][cam_j]
        all_c = torch.cat([flat_c, tc], 0)[None]
        all_d = torch.cat([flat_r, tray], 0)[None]
    else:
        all_c = flat_c[None]
        all_d = flat_r[None]

    march = sdf_mod.sphere_march(params["sdf"], cfgs.sdf, all_c, all_d)

    if tracing is not None:
        m_tr = sdf_mod.march_slice(march, n_dc, None)
        _, sdf_surf_tr, _, pts_surf_tr = sdf_mod.sphere_reeval(
            params["sdf"], cfgs.sdf, m_tr, tc[None], tray[None])
        tdist = L.safe_norm(txyz - pts_surf_tr[0], dim=-1)
        out["tracing_loss"] = L.masked_mean(tdist, tmask)
        out["sdfs_traced"] = sdf_surf_tr
        out["tmask"] = tmask
    else:
        out["tracing_loss"] = torch.zeros((), device=dev)

    ren = ren_mod.render(params["sdf"], cfgs.sdf, params["rad"], cfgs.rad,
                         cfgs.ren, centers, rays, occ_grid=occ)
    rgb = ren["rgb"]
    depth_mlp = ren["depth_mlp"]

    dc_params = _detach_tree(params["sdf"]) if dc_trace_frozen else params["sdf"]
    m_dc = sdf_mod.march_slice(march, 0, n_dc)
    d_dc, _, fin_dc, _ = sdf_mod.sphere_reeval(
        dc_params, cfgs.sdf, m_dc,
        centers.reshape(1, -1, 3), rays.reshape(1, -1, 3))
    d_points = d_dc.reshape(C, n_rays, 1)
    mask_finish = fin_dc.reshape(C, n_rays)

    mean_gt = rgbs_gt.mean(dim=-1)
    mask_bg = (mean_gt < 0.95) & (mean_gt > 0.05)
    ray_real = (torch.ones((C, n_rays), dtype=torch.bool, device=dev)
                if cam_mask is None else cam_mask[:, None].expand(C, n_rays))
    mask_bg = mask_bg & ray_real
    mask_fin = mask_finish & mask_bg

    dc_elem = L.smooth_l1(d_points[..., 0], depth_mlp[..., 0])
    dc = L.masked_mean(dc_elem, mask_fin)
    dc = torch.where(mask_fin.sum() > 0, dc, torch.zeros_like(dc))
    if cfgs.dc_unfinish_weight is not None:
        rgb_err = torch.abs(rgb - rgbs_gt).mean(dim=-1).detach()
        w_dc = torch.exp(-100.0 * rgb_err)
        dc_unf = L.masked_mean(
            w_dc * L.smooth_l1(d_points[..., 0], depth_mlp[..., 0].detach()),
            (~mask_fin) & ray_real)
        dc = dc + cfgs.dc_unfinish_weight * n_valid * dc_unf

    rgb_loss = (L.l1(rgb, rgbs_gt) if cam_mask is None
                else L.masked_mean(torch.abs(rgb - rgbs_gt).mean(dim=-1), ray_real))
    out.update(
        rgb_loss=rgb_loss,
        DC_loss=dc,
        PSNR=L.psnr(rgb, rgbs_gt, mask_bg),
        normals=ren["normals"],
        mask_bg=mask_bg,
        ray_real=ray_real,
    )
    return out


@torch.no_grad()
def guarded_update(opt: optim_mod.PhaseAdam, grads: List[torch.Tensor]):
    """Apply an optimizer update in place, skipping the step when ANY
    gradient OR update is non-finite, and sanitizing poisoned moments.

    As in the JAX package: a skipped step still advances the moments
    (with zero gradients) and the step count; the update check catches
    the inf/inf = NaN update that a finite-but-huge gradient produces
    once Adam's moments overflow; non-finite moment entries are reset to
    0. Returns ``bad`` (0.0 or 1.0) as a device tensor; nothing here
    synchronises with the host.
    """
    ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    grads = [torch.where(ok, g, torch.zeros_like(g)) for g in grads]
    updates = opt.updates(grads)
    ok = ok & torch.stack([torch.isfinite(u).all() for u in updates]).all()
    for p, u in zip(opt.leaves, updates):
        p.add_(torch.where(ok, u, torch.zeros_like(u)))
    opt.sanitize()
    return 1.0 - ok.to(torch.float32)


def eikonal_from_normals(normals, mask=None):
    n = L.safe_norm(normals, dim=-1)
    if mask is None:
        return L.l1(n, torch.ones_like(n))
    return L.masked_mean(torch.abs(n - 1.0), mask[..., None].expand(n.shape))


class InitPhase:
    """Two-view SDF+color fitting.

    batch keys:
      center_k [2,N,3], ray_k [2,N,3] — rays through inlier keypoints
      proj_pose [2,3,4]               — opposite camera w2c
      kp_src [2,N,2], kp_mask [2,N]   — projection targets + padding mask
      poses [2,3,4], intr [3,3], images [2,HW,3], grid [HW,2], occ
    """

    def __init__(self, cfgs: PhaseCfgs, weights: Dict, lr_sdf=1e-3,
                 lr_sdf_end=1e-4, lr_color=1e-2, max_iter=500):
        self.cfgs = cfgs
        self.weights = dict(weights)
        self.max_iter = max_iter
        self.lr_sdf, self.lr_color = lr_sdf, lr_color
        # the color label decays with the SDF's gamma, as in the JAX package
        self.gamma = optim_mod.decay_gamma(lr_sdf, lr_sdf_end, max_iter)

    def init_state(self, params):
        for p in optim_mod.tree_leaves(params):
            p.requires_grad_(True)
        opt = optim_mod.PhaseAdam(params, {"sdf": "sdf", "rad": "color"},
                                  {"sdf": self.lr_sdf, "color": self.lr_color},
                                  self.gamma)
        return {"params": params, "opt": opt}

    def _losses(self, params, batch, gen, rays_idx=None):
        cfgs = self.cfgs
        tr = sdf_mod.sphere_tracing(params["sdf"], cfgs.sdf,
                                    batch["center_k"], batch["ray_k"], gen=gen)
        intr = batch["intr"][None]
        uv0, _ = T.project_points(tr.pts_surface[0][None],
                                  batch["proj_pose"][0][None], intr)
        uv1, _ = T.project_points(tr.pts_surface[1][None],
                                  batch["proj_pose"][1][None], intr)
        uv = torch.stack([uv0[0], uv1[0]], 0)                    # [2,N,2]
        re = L.safe_norm(uv - batch["kp_src"], dim=-1)
        loss = {"reproj_error": L.masked_mean(re, batch["kp_mask"])}
        sdf_surf = tr.sdf_surf.reshape(2, -1)
        loss["sdf_surf"] = L.masked_mean(torch.abs(sdf_surf), batch["kp_mask"])

        rc = render_core(params, cfgs, gen, batch["poses"], batch["intr"],
                         batch["images"], batch["grid"], occ=batch.get("occ"),
                         rays_idx=rays_idx)
        loss["eikonal_loss"] = eikonal_from_normals(rc["normals"])
        loss["rgb"] = rc["rgb_loss"]
        loss["DC_Loss"] = rc["DC_loss"]
        return loss, {"PSNR": rc["PSNR"]}

    def step(self, state, batch, gen, rays_idx=None) -> Dict[str, torch.Tensor]:
        """One optimization step in place; returns 0-dim metric tensors."""
        params, opt = state["params"], state["opt"]
        loss, metrics = self._losses(params, batch, gen, rays_idx=rays_idx)
        total = L.weighted_total(loss, self.weights)
        grads = torch.autograd.grad(total, opt.leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(opt.leaves, grads)]
        bad = guarded_update(opt, grads)
        metrics.update({k: v.detach() for k, v in loss.items()})
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["all"] = total.detach()
        metrics["nonfinite"] = bad
        return metrics

    def run(self, state, batch, gen, n_iters=None):
        """``n_iters`` steps; returns (state, {metric: [n_iters] tensor})."""
        steps = [self.step(state, batch, gen)
                 for _ in range(n_iters or self.max_iter)]
        return state, {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    @torch.no_grad()
    def triangulate(self, params, batch, gen):
        """Final sphere-traced surface points for two-view triangulation
        (the host applies the 3-sigma + convergence filter)."""
        tr = sdf_mod.sphere_tracing(params["sdf"], self.cfgs.sdf,
                                    batch["center_k"], batch["ray_k"], gen=gen)
        return tr.pts_surface, tr.finish_mask.reshape(2, -1)
