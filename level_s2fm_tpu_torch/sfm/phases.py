"""Optimization phases in PyTorch: the shared render core, two-view
initialization, geoinit (SDF-based triangulation), neural bundle
adjustment and the rendering refine.

Counterpart of ``level_s2fm_tpu/sfm/phases.py`` (``render_core``,
``guarded_update``, ``eikonal_from_normals``, ``InitPhase``,
``GeoInitPhase``, ``BAPhase`` in its ``sfm`` and ``sfm_refine`` modes,
``RefinePhase``). A phase is a Python loop over one step that updates
the parameters in place; the JAX package's scan chunking
(``chunked_run``, ``LS2FM_SCAN_CHUNK``) and phase cache worked around TPU
dispatch and compile limits and are not ported.

Randomness comes from a CPU ``torch.Generator`` passed by the caller.
Every draw can also be given, so tests can hand both packages the same
draws: the rays (``rays_idx``) and the tracing camera (``trace_cam``) of
``render_core``, the eikonal samples of a sphere trace (``draws``) and
geoinit's existing-point subsample (``exist_pick``).

Data parallel (``parallel``): under an active group, ``render_core``
shards its rays and tracing rows over the ranks, and ``BAPhase`` its
track rows (``shard_rows``; the draws are made for the global batch, so
N ranks draw what one draws). Their loss terms are the ranks' parts of
the global means (``losses.masked_mean(sharded=True)``), their gradients
are summed over the ranks before ``guarded_update`` (``descend(sharded=
True)``) and the metrics a step returns are the global values. The
phases the JAX package does not shard (``GeoInitPhase``, the trad
phases) run in full on every rank and take rank 0's gradient; the init's
keypoint terms count once (``losses.replicated``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..fields import radiance as radf
from ..fields import sdf as sdf_mod
from ..geometry import lie, transforms as T
from ..parallel import distributed as pdist
from ..parallel import mesh as pmesh
from ..rendering import renderer as ren_mod
from ..utils import obs
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


@obs.traced("render_core")
def render_core(params, cfgs: PhaseCfgs, gen: Optional[torch.Generator],
                poses, intr, images, grid, tracing=None, occ=None,
                dc_trace_frozen: bool = False, cam_mask=None, n_real=None,
                rays_idx=None, trace_cam=None):
    """Random-ray multi-view render + the standard loss bundle.

    poses [C,3,4]; intr [3,3]; images [C,HW,3]; grid [HW,2].
    tracing: optional dict of per-camera padded tracked-keypoint data
      {"center" [C,Nt,3], "ray" [C,Nt,3], "xyz" [C,Nt,3], "mask" [C,Nt]}
      for the multi-view sphere-trace consistency loss.
    ONE sphere march serves the DC-loss rays and the tracing rays.
    ``dc_trace_frozen`` re-evaluates the DC track with a frozen SDF.
    ``cam_mask`` [C] bool marks the real cameras of a padded camera axis,
    which are its prefix of ``n_real`` (a host int, so that drawing the
    tracing camera needs no sync).
    ``rays_idx`` [n_rays] replaces the random draw of the rays,
    ``trace_cam`` (an int) the draw of the tracing camera.
    Under an active data group the per-camera ray count is rounded up to
    a multiple of the ranks, and each rank keeps its rows of the rays
    (axis 1 of [C,R,3]) and of the tracing rows.
    Returns dict of losses/metrics (each loss this rank's part of the
    global value) plus 'normals', 'mask_bg', 'ray_real' and 'ray_rows'
    (the valid rows of a sharded batch, else None).
    """
    dev = poses.device
    C = poses.shape[0]
    HW = cfgs.H * cfgs.W
    n_rays = max(cfgs.rand_rays // C, 1)
    world = pmesh.world_size()
    if world > 1:
        n_rays = -(-n_rays // world) * world
    n_rays = min(n_rays, HW)
    if rays_idx is None:
        rays_idx = torch.randperm(HW, generator=gen)[:n_rays]
    rays_idx, rows = pmesh.shard_rows(torch.as_tensor(rays_idx, device=dev))
    n_rays = rays_idx.shape[0]
    centers, rays = T.get_center_and_ray(poses, intr, grid[rays_idx])  # [C,R,3]
    rgbs_gt = images[:, rays_idx]

    n_valid = C if cam_mask is None else cam_mask.sum()
    out = {}
    flat_c = centers.reshape(-1, 3)
    flat_r = rays.reshape(-1, 3)
    n_dc = flat_c.shape[0]
    if tracing is not None:
        cam_j = trace_cam
        if cam_j is None:
            cam_j = int(torch.randint(0, C if n_real is None else n_real, (),
                                      generator=gen))
        tc, t_rows = pmesh.shard_rows(tracing["center"][cam_j])
        tray, _ = pmesh.shard_rows(tracing["ray"][cam_j])
        txyz, _ = pmesh.shard_rows(tracing["xyz"][cam_j])
        tmask, _ = pmesh.shard_rows(tracing["mask"][cam_j])
        all_c = torch.cat([flat_c, tc], 0)[None]
        all_d = torch.cat([flat_r, tray], 0)[None]
    else:
        all_c = flat_c[None]
        all_d = flat_r[None]
    march_rows = None
    if rows is not None:
        march_rows = rows[None].expand(C, n_rays).reshape(-1)
        if tracing is not None:
            tmask = tmask & t_rows
            march_rows = torch.cat([march_rows, t_rows], 0)

    stop_count = None
    if march_rows is not None:
        # the march stops when no valid ray of any rank is unfinished
        def stop_count(unf):
            return pdist.global_sum([(unf & march_rows).sum()])[0]
    march = sdf_mod.sphere_march(params["sdf"], cfgs.sdf, all_c, all_d,
                                 stop_count=stop_count)

    if tracing is not None:
        m_tr = sdf_mod.march_slice(march, n_dc, None)
        _, sdf_surf_tr, _, pts_surf_tr = sdf_mod.sphere_reeval(
            params["sdf"], cfgs.sdf, m_tr, tc[None], tray[None])
        tdist = L.safe_norm(txyz - pts_surf_tr[0], dim=-1)
        out["tracing_loss"] = L.masked_mean(tdist, tmask, sharded=True)
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
    if rows is not None:
        ray_real = ray_real & rows[None]
    mask_bg = mask_bg & ray_real
    mask_fin = mask_finish & mask_bg

    dc_elem = L.smooth_l1(d_points[..., 0], depth_mlp[..., 0])
    dc = L.masked_mean(dc_elem, mask_fin, sharded=True)
    dc = torch.where(L.count(mask_fin, sharded=True) > 0, dc, torch.zeros_like(dc))
    if cfgs.dc_unfinish_weight is not None:
        rgb_err = torch.abs(rgb - rgbs_gt).mean(dim=-1).detach()
        w_dc = torch.exp(-100.0 * rgb_err)
        dc_unf = L.masked_mean(
            w_dc * L.smooth_l1(d_points[..., 0], depth_mlp[..., 0].detach()),
            (~mask_fin) & ray_real, sharded=True)
        dc = dc + cfgs.dc_unfinish_weight * n_valid * dc_unf

    rgb_loss = (L.l1(rgb, rgbs_gt) if cam_mask is None and rows is None
                else L.masked_mean(torch.abs(rgb - rgbs_gt).mean(dim=-1), ray_real,
                                   sharded=True))
    out.update(
        rgb_loss=rgb_loss,
        DC_loss=dc,
        PSNR=L.psnr(rgb, rgbs_gt, mask_bg, sharded=True),
        normals=ren["normals"],
        mask_bg=mask_bg,
        ray_real=ray_real,
        ray_rows=None if rows is None else ray_real,
    )
    return out


@obs.traced("optim.update")
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


def descend(opt: optim_mod.PhaseAdam, total: torch.Tensor, sharded=False):
    """Gradient of ``total`` w.r.t. the optimizer's leaves (zero where a
    leaf does not reach it), applied through ``guarded_update``. Under an
    active data group the gradients are first summed over the ranks
    (``sharded``: each rank's total is its part of the global loss) or
    replaced by rank 0's (a phase every rank runs in full), so that every
    rank makes the same update."""
    with obs.span("backward"):
        grads = torch.autograd.grad(total, opt.leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(opt.leaves, grads)]
    if sharded:
        grads = pdist.all_reduce_grads(grads)
    else:
        grads = pmesh.replicate(grads)
    return guarded_update(opt, grads)


def step_metrics(loss, metrics, total, bad, sharded=False) -> Dict[str, torch.Tensor]:
    """A step's detached metrics: the loss terms, ``all`` and
    ``nonfinite`` beside the phase's own. ``sharded``: the loss terms and
    ``all`` are the ranks' parts, summed here in one all-reduce (the
    phase's own metrics are global values already)."""
    out = {k: v.detach() for k, v in metrics.items()}
    vals = pdist.global_sum(list(loss.values()) + [total]) if sharded else [
        v.detach() for v in list(loss.values()) + [total]]
    out.update(zip(loss, vals[:-1]))
    out["all"] = vals[-1]
    out["nonfinite"] = bad
    return out


def run_steps(phase, state, batch, gen, n_iters=None):
    """``n_iters`` steps of ``phase``; returns (state, {metric: [n]})."""
    steps = [phase.step(state, batch, gen)
             for _ in range(n_iters or phase.max_iter)]
    return state, {k: torch.stack([m[k] for m in steps]) for k in steps[0]}


def _trainable(params, keys):
    for k in keys:
        for p in optim_mod.tree_leaves(params[k]):
            p.requires_grad_(True)


def eikonal_from_normals(normals, mask=None):
    """Mean | |n| - 1 | over render_core's normals [C,R,K,3]; ``mask``
    [C,R] selects rays (of a sharded batch: the global mean)."""
    n = L.safe_norm(normals, dim=-1)
    if mask is None:
        return L.l1(n, torch.ones_like(n))
    return L.masked_mean(torch.abs(n - 1.0), mask[..., None].expand(n.shape),
                         sharded=True)


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
        _trainable(params, ("sdf", "rad"))
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
        # the keypoint terms: every rank traces every keypoint
        loss = {"reproj_error": L.replicated(L.masked_mean(re, batch["kp_mask"]))}
        sdf_surf = tr.sdf_surf.reshape(2, -1)
        loss["sdf_surf"] = L.replicated(
            L.masked_mean(torch.abs(sdf_surf), batch["kp_mask"]))

        rc = render_core(params, cfgs, gen, batch["poses"], batch["intr"],
                         batch["images"], batch["grid"], occ=batch.get("occ"),
                         rays_idx=rays_idx)
        loss["eikonal_loss"] = eikonal_from_normals(rc["normals"], rc["ray_rows"])
        loss["rgb"] = rc["rgb_loss"]
        loss["DC_Loss"] = rc["DC_loss"]
        return loss, {"PSNR": rc["PSNR"]}

    @obs.traced("step.init")
    def step(self, state, batch, gen, rays_idx=None) -> Dict[str, torch.Tensor]:
        """One optimization step in place; returns 0-dim metric tensors."""
        loss, metrics = self._losses(state["params"], batch, gen,
                                     rays_idx=rays_idx)
        total = L.weighted_total(loss, self.weights)
        return step_metrics(loss, metrics, total,
                            descend(state["opt"], total, sharded=True), sharded=True)

    def run(self, state, batch, gen, n_iters=None):
        """``n_iters`` steps; returns (state, {metric: [n_iters] tensor})."""
        return run_steps(self, state, batch, gen, n_iters)

    @torch.no_grad()
    def triangulate(self, params, batch, gen):
        """Final sphere-traced surface points for two-view triangulation
        (the host applies the 3-sigma + convergence filter)."""
        tr = sdf_mod.sphere_tracing(params["sdf"], self.cfgs.sdf,
                                    batch["center_k"], batch["ray_k"], gen=gen)
        return tr.pts_surface, tr.finish_mask.reshape(2, -1)


class GeoInitPhase:
    """New-view triangulation: fit the SDF so that rays through matched
    keypoints of the new view and of its source views meet on the
    surface; the radiance field is frozen.

    batch keys (P = padded pair-observation count, S = #src-view pairs):
      center [2,P,3], ray [2,P,3]   — row0: rays from the NEW camera,
                                       row1: rays from the source cameras
      kp_src [2,P,2]                — row0: targets in src cam; row1: in new cam
      pose0 [P,3,4]                 — src-cam pose (projects new-cam-traced pts)
      pose1 [P,3,4]                 — new-cam pose (projects src-cam-traced pts)
      seg [P]                       — pair index in [0,S)
      valid [P]                     — padding mask
      mask_new [P]                  — new-cam keypoint has no 3D point yet
      xyz_target [P,3], has_target [P] — existing 3D point for tracked kypts
      pts_exists [E,3], pts_mask [E]   — existing point cloud (sdf/eikonal reg)
      intr [3,3]
    """

    def __init__(self, cfgs: PhaseCfgs, weights: Dict, n_segments: int,
                 lr_sdf=1e-3, lr_sdf_end=1e-3, max_iter=500, reproj_max=15.0,
                 exist_subsample=4096):
        self.cfgs = cfgs
        self.weights = dict(weights)
        self.max_iter = max_iter
        self.n_segments = n_segments
        self.reproj_max = reproj_max
        self.exist_subsample = exist_subsample
        self.lr_sdf = lr_sdf
        self.gamma = optim_mod.decay_gamma(lr_sdf, lr_sdf_end, max_iter)

    def init_state(self, params):
        _trainable(params, ("sdf",))
        opt = optim_mod.PhaseAdam(params, {"sdf": "sdf", "rad": optim_mod.FROZEN},
                                  {"sdf": self.lr_sdf}, self.gamma)
        return {"params": params, "opt": opt}

    def _trace_and_masks(self, params, batch, gen, draws=None):
        tr = sdf_mod.sphere_tracing(params["sdf"], self.cfgs.sdf, batch["center"],
                                    batch["ray"], gen=gen, draws=draws)
        pts = tr.pts_surface                       # [2,P,3]
        finish = tr.finish_mask.reshape(2, -1)     # [2,P]
        uv0, _ = project_points_per(pts[0], batch["pose0"], batch["intr"])
        uv1, _ = project_points_per(pts[1], batch["pose1"], batch["intr"])
        re0 = L.safe_norm(uv0 - batch["kp_src"][0], dim=-1)
        re1 = L.safe_norm(uv1 - batch["kp_src"][1], dim=-1)
        rmax = self.reproj_max
        reject = ((finish[0] & (re0 > rmax)) & (finish[1] & (re1 > rmax))) | (
            (re0 > 2 * rmax) & (re1 > 2 * rmax))
        reject = reject | (re0 > 4 * rmax) | (re1 > 4 * rmax)
        return tr, pts, finish, re0, re1, reject

    def _losses(self, params, batch, gen, draws=None, exist_pick=None):
        cfgs = self.cfgs
        tr, pts, _, re0, re1, reject = self._trace_and_masks(
            params, batch, gen, draws)
        valid = batch["valid"]
        mask_new = batch["mask_new"] & valid
        # per-pair means as one-hot matmuls over the S <= 64 segments
        seg_onehot = (batch["seg"][:, None] == torch.arange(
            self.n_segments, device=valid.device)[None, :]).to(re0.dtype)
        w_re = (mask_new & ~reject).to(re0.dtype)
        seg_sum = ((re0 + re1) / 2 * w_re) @ seg_onehot
        seg_cnt = w_re @ seg_onehot
        has_re = seg_cnt > 0
        per_seg = torch.where(has_re, seg_sum / torch.clamp(seg_cnt, min=1.0), 0.0)
        n_frames_re = has_re.sum()
        reproj = per_seg.sum() / torch.clamp(n_frames_re, min=1)

        # tracing loss for already-tracked keypoints of the new camera
        w_tr = (~batch["mask_new"] & valid & batch["has_target"]).to(re0.dtype)
        tdist = L.safe_norm(batch["xyz_target"] - pts[0], dim=-1)
        seg_tcnt = w_tr @ seg_onehot
        has_t = seg_tcnt > 0
        per_seg_t = torch.where(has_t, ((tdist * w_tr) @ seg_onehot)
                                / torch.clamp(seg_tcnt, min=1.0), 0.0)
        tracing = per_seg_t.sum() / torch.clamp(has_t.sum(), min=1)

        # sdf-surface + eikonal regularization with existing points
        E = batch["pts_exists"].shape[0]
        if exist_pick is None:
            exist_pick = torch.randperm(E, generator=gen)[:min(self.exist_subsample, E)]
        exist_pick = torch.as_tensor(exist_pick, device=valid.device)
        pe = batch["pts_exists"][exist_pick]
        pe_mask = batch["pts_mask"][exist_pick]
        sdf_e, _, g_exist = sdf_mod.infer_all_with_normal(params["sdf"], cfgs.sdf, pe)
        sdf_e = sdf_e[..., 0]
        near = (torch.abs(sdf_e) < cfgs.sdf.sdf_threshold) & pe_mask
        kp_mask2 = torch.cat([valid, valid], 0)
        sdf_abs_sum = (torch.sum(torch.abs(sdf_e) * near)
                       + torch.sum(torch.abs(tr.sdf_surf) * kp_mask2))
        sdf_cnt = near.sum() + kp_mask2.sum()
        sdf_surf = sdf_abs_sum / torch.clamp(sdf_cnt, min=1.0)

        g_samp = sdf_mod.gradient(params["sdf"], cfgs.sdf, tr.sample_pts)
        gn = torch.cat([L.safe_norm(g_exist, dim=-1),
                        L.safe_norm(g_samp[0], dim=-1)], 0)
        gmask = torch.cat([pe_mask, torch.ones(g_samp.shape[1], dtype=torch.bool,
                                               device=pe_mask.device)], 0)
        eik = L.masked_mean(torch.abs(gn - 1.0), gmask)

        # drop reproj when no frame has accepted observations
        loss = {"reproj_error": torch.where(n_frames_re > 0, reproj, 0.0),
                "tracing_loss": tracing, "sdf_surf": sdf_surf,
                "eikonal_loss": eik}
        return loss, {"n_frames_re": n_frames_re}

    def step(self, state, batch, gen, draws=None, exist_pick=None):
        loss, metrics = self._losses(state["params"], batch, gen, draws, exist_pick)
        total = L.weighted_total(loss, self.weights)
        return step_metrics(loss, metrics, total, descend(state["opt"], total))

    def run(self, state, batch, gen, n_iters=None):
        return run_steps(self, state, batch, gen, n_iters)

    @torch.no_grad()
    def final(self, params, batch, gen, draws=None):
        """Final trace for the host-side point acceptance."""
        _, pts, finish, _, _, reject = self._trace_and_masks(params, batch, gen,
                                                             draws)
        w_tr = ~batch["mask_new"] & batch["valid"] & batch["has_target"]
        tdist = L.safe_norm(batch["xyz_target"] - pts[0], dim=-1)
        return {"pts": pts, "finish": finish, "reject": reject,
                "trace_dist": tdist, "trace_mask": w_tr}


class BAPhase:
    """Joint pose + field optimization.

    params: {"sdf","rad","se3_r" [C,3],"se3_t" [C,3]}; the track points are
    not free variables: they are re-projected onto the SDF zero set each
    step and carried in the state.

    Modes: ``sfm`` is pure reprojection (no rendering; the radiance field
    is frozen, which is exact: its gradient is zero); ``sfm_refine`` adds
    the rendering losses, with pose gradients through the rendered rays
    when a single camera is optimized; ``rad_init`` trains the fields on
    the same losses with the poses frozen.

    batch keys:
      pose_idx [P], kp [P,2], valid [P], intr [3,3]
      images [C,HW,3], grid [HW,2], cam_mask [C], n_real (int)
      tracing {"center","ray","xyz","mask"} per-camera padded
    """

    def __init__(self, cfgs: PhaseCfgs, weights: Dict, mode: str = "sfm",
                 single_cam: bool = False,
                 lr_sdf=1e-4, lr_sdf_end=5e-5, lr_color=1e-3,
                 lr_pose_r=5e-3, lr_pose_t=1e-2, max_iter=1000):
        if mode not in ("sfm", "sfm_refine", "rad_init"):
            raise ValueError(f"unknown BAPhase mode {mode!r}")
        self.cfgs = cfgs
        self.weights = dict(weights)
        self.mode = mode
        self.single_cam = single_cam
        self.max_iter = max_iter
        self.gamma = optim_mod.decay_gamma(lr_sdf, lr_sdf_end, max_iter)
        pose = optim_mod.FROZEN if mode == "rad_init" else None
        self.label_of = {"sdf": "sdf", "se3_r": pose or "pose_r",
                         "se3_t": pose or "pose_t",
                         "rad": optim_mod.FROZEN if mode == "sfm" else "color"}
        self.lrs = {"sdf": lr_sdf, "color": lr_color, "pose_r": lr_pose_r,
                    "pose_t": lr_pose_t}

    def init_state(self, params, xyzs):
        """``xyzs`` [P,3]: the track points; under an active data group
        the state carries this rank's rows (``fetch_host`` gathers them)."""
        _trainable(params, [k for k, lab in self.label_of.items()
                            if lab != optim_mod.FROZEN])
        opt = optim_mod.PhaseAdam(params, self.label_of, self.lrs, self.gamma)
        return {"params": params, "opt": opt, "xyzs": pmesh.shard_rows(xyzs)[0]}

    def _losses(self, params, xyzs, batch, gen, rays_idx=None, trace_cam=None):
        cfgs = self.cfgs
        thr = cfgs.sdf.finish_threshold
        se3 = torch.cat([params["se3_r"], params["se3_t"]], dim=1)       # [C,6]
        xyzs_new, normals_value = sdf_mod.get_surface_pts(params["sdf"], cfgs.sdf,
                                                          xyzs)
        sdfs = sdf_mod.infer_sdf(params["sdf"], cfgs.sdf, xyzs_new)[..., 0]
        # this rank's track rows (xyzs are carried sharded in the state)
        pose_idx, _ = pmesh.shard_rows(batch["pose_idx"])
        kp, _ = pmesh.shard_rows(batch["kp"])
        valid, rows = pmesh.shard_rows(batch["valid"])
        if rows is not None:
            valid = valid & rows
        poses_fwd = lie.se3_to_SE3(se3[pose_idx])                         # [P,3,4]
        uv, _ = project_points_per(xyzs_new, poses_fwd, batch["intr"])
        r = L.safe_norm(uv - kp, dim=-1)
        mask_surf = (torch.abs(sdfs) < 2 * thr) & valid
        mask_ok = mask_surf & torch.isfinite(r)
        robust = 0.5 * (2 * torch.log(1 + r ** 2 / 4)) + 0.5 * r
        n_surf = L.count(mask_surf, sharded=True)
        reproj_loss = torch.where(n_surf > 0,
                                  L.masked_mean(robust, mask_ok, sharded=True), 0.0)
        loss = {"reproj_error": reproj_loss,
                "sdf_surf": L.masked_mean(torch.abs(sdfs), valid, sharded=True)}
        metrics = {"reproj_px": L.global_value(
                       L.masked_mean(r, mask_ok, sharded=True)),
                   "pts3d_ratio": n_surf / torch.clamp(
                       L.count(valid, sharded=True), min=1)}
        if self.mode == "sfm":
            loss["eikonal_loss"] = L.masked_mean(
                torch.abs(normals_value[..., 0] - 1.0), valid, sharded=True)
        else:
            pose_input = lie.se3_to_SE3(se3)
            if not self.single_cam:
                pose_input = pose_input.detach()
            rc = render_core(params, cfgs, gen, pose_input, batch["intr"],
                             batch["images"], batch["grid"],
                             tracing=batch["tracing"], occ=batch.get("occ"),
                             dc_trace_frozen=True, cam_mask=batch.get("cam_mask"),
                             n_real=batch.get("n_real"), rays_idx=rays_idx,
                             trace_cam=trace_cam)
            loss["eikonal_loss"] = eikonal_from_normals(rc["normals"], rc["mask_bg"])
            loss["rgb"] = rc["rgb_loss"]
            loss["DC_Loss"] = rc["DC_loss"]
            loss["tracing_loss"] = rc["tracing_loss"]
            metrics["PSNR"] = rc["PSNR"]
        return loss, metrics, xyzs_new

    def objective(self, loss, metrics):
        """The weighted total, with the dynamic reprojection weight: 10x
        while the mean error is above 10 px (a device tensor: no sync)."""
        w_re = torch.where(metrics["reproj_px"] > 10.0, 1.0, 0.0)
        total = L.weighted_total({k: v for k, v in loss.items()
                                  if k != "reproj_error"}, self.weights)
        return total + torch.pow(10.0, w_re) * loss["reproj_error"]

    @obs.traced("step.ba")
    def step(self, state, batch, gen, rays_idx=None, trace_cam=None):
        loss, metrics, xyzs_new = self._losses(state["params"], state["xyzs"],
                                               batch, gen, rays_idx, trace_cam)
        total = self.objective(loss, metrics)
        out = step_metrics(loss, metrics, total,
                           descend(state["opt"], total, sharded=True), sharded=True)
        # the carried points: a non-finite projection keeps the old point
        xyzs_new = xyzs_new.detach()
        fin = torch.isfinite(xyzs_new).all(dim=-1, keepdim=True)
        state["xyzs"] = torch.where(fin, xyzs_new, state["xyzs"])
        return out

    def run(self, state, batch, gen, n_iters=None):
        return run_steps(self, state, batch, gen, n_iters)


class RefinePhase:
    """Poses fixed; fit both fields on the rendering losses.

    batch keys: poses [C,3,4], intr, images [C,HW,3], grid, tracing{...},
    cam_mask [C], n_real (int).
    """

    def __init__(self, cfgs: PhaseCfgs, weights: Dict,
                 lr_sdf=1e-3, lr_sdf_end=5e-4, lr_color=1e-3, max_iter=500):
        self.cfgs = cfgs
        self.weights = dict(weights)
        self.max_iter = max_iter
        self.lr_sdf, self.lr_color = lr_sdf, lr_color
        self.gamma = optim_mod.decay_gamma(lr_sdf, lr_sdf_end, max_iter)

    def init_state(self, params):
        _trainable(params, ("sdf", "rad"))
        opt = optim_mod.PhaseAdam(params, {"sdf": "sdf", "rad": "color"},
                                  {"sdf": self.lr_sdf, "color": self.lr_color},
                                  self.gamma)
        return {"params": params, "opt": opt}

    def _losses(self, params, batch, gen, rays_idx=None, trace_cam=None):
        rc = render_core(params, self.cfgs, gen, batch["poses"], batch["intr"],
                         batch["images"], batch["grid"],
                         tracing=batch["tracing"], occ=batch.get("occ"),
                         cam_mask=batch.get("cam_mask"),
                         n_real=batch.get("n_real"), rays_idx=rays_idx,
                         trace_cam=trace_cam)
        loss = {
            "eikonal_loss": eikonal_from_normals(rc["normals"], rc["ray_real"]),
            "rgb": rc["rgb_loss"],
            "DC_Loss": rc["DC_loss"],
            "tracing_loss": rc["tracing_loss"],
            # refine's sdf_surf acts on the traced keypoints' sdf
            "sdf_surf": L.masked_mean(torch.abs(rc["sdfs_traced"]), rc["tmask"],
                                      sharded=True),
        }
        return loss, {"PSNR": rc["PSNR"]}

    @obs.traced("step.refine")
    def step(self, state, batch, gen, rays_idx=None, trace_cam=None):
        loss, metrics = self._losses(state["params"], batch, gen, rays_idx,
                                     trace_cam)
        total = L.weighted_total(loss, self.weights)
        return step_metrics(loss, metrics, total,
                            descend(state["opt"], total, sharded=True), sharded=True)

    def run(self, state, batch, gen, n_iters=None):
        return run_steps(self, state, batch, gen, n_iters)
