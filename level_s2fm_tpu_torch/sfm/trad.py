"""Traditional-SfM ablation paths: DLT triangulation and classic BA.

Counterpart of ``level_s2fm_tpu/sfm/trad.py``, enabled by
``Ablate_config.tri_trad`` / ``Ablate_config.ba_trad``:

* ``SdfFitPhase`` / ``fit_sdf_to_points`` — after a DLT triangulation,
  fit the SDF to the fixed points (sphere tracing through their
  keypoints + sdf at the points + eikonal), the radiance field frozen.
* ``BATradPhase`` / ``TradBundler`` — gradient-descent bundle adjustment
  with the 3D points as free variables and se(3) poses under a pure
  reprojection loss; nothing is rendered.
* ``triangulate_pair_dlt`` — DLT of one camera pair in the world frame.

Phases are Python loops over ``PhaseAdam`` + ``guarded_update``, as the
port's other phases; like the JAX package's, they neither record nor
adopt an optimizer state (``optstate``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..fields import sdf as sdf_mod
from ..geometry import lie
from . import entities, hostgeom
from . import losses as L
from . import optim as optim_mod
from .phases import (PhaseCfgs, _trainable, descend, project_points_per,
                     run_steps)


class SdfFitPhase:
    """Fit the SDF to fixed 3D points.

    batch: center [1,N,3], ray [1,N,3] (rays through the triangulated
    keypoints), pts_at_rays [N,3] (each ray's point), kp_mask [N], pts
    [M,3], pts_mask [M]. Losses: tracing (traced surface vs the ray's
    point), sdf_surf at the points, eikonal at the trace's samples.
    """

    weights = {"tracing_loss": 1, "sdf_surf": 2, "eikonal_loss": 2}

    def __init__(self, cfgs: PhaseCfgs, lr_sdf=1e-3, lr_sdf_end=1e-4,
                 max_iter=200):
        self.cfgs = cfgs
        self.max_iter = max_iter
        self.lr_sdf = lr_sdf
        self.gamma = optim_mod.decay_gamma(lr_sdf, lr_sdf_end, max_iter)

    def init_state(self, params):
        _trainable(params, ("sdf",))
        opt = optim_mod.PhaseAdam(params, {"sdf": "sdf", "rad": optim_mod.FROZEN},
                                  {"sdf": self.lr_sdf}, self.gamma)
        return {"params": params, "opt": opt}

    def _losses(self, params, batch, gen, draws=None):
        cfgs = self.cfgs
        tr = sdf_mod.sphere_tracing(params["sdf"], cfgs.sdf, batch["center"],
                                    batch["ray"], gen=gen, draws=draws)
        tdist = L.safe_norm(batch["pts_at_rays"] - tr.pts_surface[0], dim=-1)
        sdf_p = sdf_mod.infer_sdf(params["sdf"], cfgs.sdf, batch["pts"])[..., 0]
        g = sdf_mod.gradient(params["sdf"], cfgs.sdf, tr.sample_pts)
        return {"tracing_loss": L.masked_mean(tdist, batch["kp_mask"]),
                "sdf_surf": L.masked_mean(torch.abs(sdf_p), batch["pts_mask"]),
                "eikonal_loss": L.l1(L.safe_norm(g, dim=-1), 1.0)}

    def step(self, state, batch, gen, draws=None) -> Dict[str, torch.Tensor]:
        loss = self._losses(state["params"], batch, gen, draws)
        total = L.weighted_total(loss, self.weights)
        bad = descend(state["opt"], total)
        out = {k: v.detach() for k, v in loss.items()}
        out["all"] = total.detach()
        out["nonfinite"] = bad
        return out

    def run(self, params, batch, gen, n_iters=None):
        """Returns (params, {metric: [n] tensor})."""
        state, metrics = run_steps(self, self.init_state(params), batch, gen,
                                   n_iters)
        return state["params"], metrics


def fit_sdf_to_points(opt, cfgs: PhaseCfgs, params, pts: np.ndarray,
                      center: np.ndarray, ray: np.ndarray,
                      gen: torch.Generator, max_iter: int = 200):
    """Pad the per-keypoint arrays [n,3] (each ray's triangulated point is
    its tracing target) to a bucket and run ``SdfFitPhase``. Returns the
    parameters."""
    n = center.shape[0]
    assert pts.shape[0] == n
    N = entities.pad_to_bucket(max(n, 1))
    c = np.zeros((1, N, 3), np.float32)
    r = np.zeros((1, N, 3), np.float32)
    r[..., 2] = 1.0
    p_at = np.zeros((N, 3), np.float32)
    c[0, :n], r[0, :n], p_at[:n] = center, ray, pts
    mask = np.arange(N) < n
    dev = params["sdf"]["table"].device
    on = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
    batch = {"center": on(c), "ray": on(r), "pts_at_rays": on(p_at),
             "kp_mask": on(mask), "pts": on(p_at), "pts_mask": on(mask)}
    params, _ = SdfFitPhase(cfgs, max_iter=max_iter).run(params, batch, gen)
    return params


class BATradPhase:
    """Classic gradient BA: free xyzs + se3 poses, pure reprojection loss.

    params: {"se3_r" [C,3], "se3_t" [C,3], "xyzs" [U,3]}; batch:
    pose_idx [P], obs_to_pt [P], kp [P,2], valid [P], intr [3,3].
    The learning rates decay to ``lr_end_scale`` of their base over
    ``max_iter`` steps.
    """

    def __init__(self, cfgs: PhaseCfgs, lr_pose_r=5e-3, lr_pose_t=1e-2,
                 lr_xyzs=1e-2, lr_end_scale=0.5, max_iter=1000):
        self.cfgs = cfgs
        self.max_iter = max_iter
        self.lrs = {"pose_r": lr_pose_r, "pose_t": lr_pose_t, "xyzs": lr_xyzs}
        self.gamma = lr_end_scale ** (1.0 / max_iter)

    def init_state(self, params):
        _trainable(params, params)
        opt = optim_mod.PhaseAdam(
            params, {"se3_r": "pose_r", "se3_t": "pose_t", "xyzs": "xyzs"},
            self.lrs, self.gamma)
        return {"params": params, "opt": opt}

    def step(self, state, batch, gen=None) -> Dict[str, torch.Tensor]:
        params = state["params"]
        se3 = torch.cat([params["se3_r"], params["se3_t"]], dim=1)
        poses = lie.se3_to_SE3(se3[batch["pose_idx"]])
        uv, _ = project_points_per(params["xyzs"][batch["obs_to_pt"]], poses,
                                   batch["intr"])
        r = L.safe_norm(uv - batch["kp"], dim=-1)
        loss = L.masked_mean(r, batch["valid"] & torch.isfinite(r))
        return {"reproj_px": loss.detach(), "nonfinite": descend(state["opt"], loss)}

    def run(self, params, batch, gen=None, n_iters=None):
        """Returns (params, {metric: [n] tensor})."""
        state, metrics = run_steps(self, self.init_state(params), batch, gen,
                                   n_iters)
        return state["params"], metrics


class TradBundler:
    """``BATradPhase`` over picked cameras (all by default); writes the
    poses and the points back."""

    def __init__(self, opt, cfgs: PhaseCfgs, cameraset: entities.CameraSet,
                 pointset: entities.PointSet,
                 cam_pick_ids: Optional[List[int]] = None, device=None):
        self.opt = opt
        self.cameraset = cameraset
        self.pointset = pointset
        self.cam_pick_ids = (list(cam_pick_ids) if cam_pick_ids is not None
                             else list(cameraset.cam_ids))
        self.local = cam_pick_ids is not None
        ob = opt.optim.ba
        max_iter = int(ob.max_iter)
        if cam_pick_ids is not None and len(cam_pick_ids) == 1:
            max_iter //= 2
        pts_id, pose_idx, kypts = entities.gather_track_observations(
            cameraset, self.cam_pick_ids)
        # unique points become free variables; observations index into them
        uniq, inv = np.unique(pts_id, return_inverse=True)
        self.uniq_pts = uniq
        P = entities.pad_to_bucket(max(len(pts_id), 1))
        U = entities.pad_to_bucket(max(len(uniq), 1))
        kp = np.zeros((P, 2), np.float32)
        kp[:len(pts_id)] = kypts
        pidx = np.zeros(P, np.int64)
        pidx[:len(pts_id)] = pose_idx
        oidx = np.zeros(P, np.int64)
        oidx[:len(pts_id)] = inv.reshape(-1)
        valid = np.zeros(P, bool)
        valid[:len(pts_id)] = True
        xyzs = np.zeros((U, 3), np.float32)
        xyzs[:len(uniq)] = pointset.get_xyzs(uniq)
        on = lambda x: torch.as_tensor(x).to(device)  # noqa: E731
        self.batch = {"pose_idx": on(pidx), "kp": on(kp), "valid": on(valid),
                      "obs_to_pt": on(oidx),
                      "intr": on(np.asarray(cameraset(self.cam_pick_ids[0]).intr,
                                            np.float32))}
        self.xyzs0 = xyzs
        self.device = device
        self.phase = BATradPhase(cfgs, lr_pose_r=float(ob.lr_pose_r),
                                 lr_pose_t=float(ob.lr_pose_t),
                                 lr_xyzs=float(opt.optim.lr_xyzs),
                                 max_iter=max_iter)

    def run(self, params, gen=None, verbose=True) -> tuple:
        """Returns (params, the last step's reprojection px); the field
        parameters pass through untouched."""
        se3 = self.cameraset.all_se3(self.cam_pick_ids)
        on = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(self.device)  # noqa: E731
        trad = {"se3_r": on(se3[:, :3]), "se3_t": on(se3[:, 3:]),
                "xyzs": on(self.xyzs0)}
        new, metrics = self.phase.run(trad, self.batch, gen)
        self.metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        reproj = float(self.metrics["reproj_px"][-1])
        if verbose:
            name = "local_ba_trad" if self.local else "global_ba_trad"
            print({"phase": name, "reproj_px": round(reproj, 4)})
        se3_new = torch.cat([new["se3_r"], new["se3_t"]], 1).detach().cpu().numpy()
        for j, cid in enumerate(self.cam_pick_ids):
            self.cameraset(cid).se3 = se3_new[j].copy()
        self.pointset.update_xyzs(
            self.uniq_pts,
            new["xyzs"].detach().cpu().numpy()[:len(self.uniq_pts)])
        return params, reproj


def triangulate_pair_dlt(cam_a: entities.Camera, cam_b: entities.Camera,
                         kp_a: np.ndarray, kp_b: np.ndarray) -> np.ndarray:
    """DLT triangulation of matched keypoints in the world frame."""
    return hostgeom.triangulate_dlt(kp_a, kp_b, cam_a.intr @ cam_a.pose(),
                                    cam_b.intr @ cam_b.pose())
