"""Two-view initialization: pose bootstrap + SDF/color fitting +
triangulation.

Counterpart of ``level_s2fm_tpu/sfm/initialization.py``: camera 0 on a
sphere of radius rad_init, the relative pose by essential-matrix RANSAC
(minigeom), then ``InitPhase`` fits the fields for max_iter steps (with
the occupancy grid rebuilt between segments), and the final traced
surface points are filtered (3-sigma + SDF convergence) into the
PointSet (the match images go to ``output_path/init_mch/``). Under the
``tri_trad`` ablation the keypoints are DLT-triangulated from the two
bootstrapped poses instead (cheirality + bounds mask) and the SDF is
fitted to the points afterwards (``trad.fit_sdf_to_points``, 200 steps).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import scene_opt
from ..geometry import lie, transforms as T
from . import entities, hostgeom, optstate
from .phases import InitPhase, PhaseCfgs


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def bootstrap_cam0_pose(opt) -> np.ndarray:
    """First camera on a sphere of radius rad_init."""
    rad = scene_opt(opt, "rad_init", opt.data.bound_max[0] / 2)
    if opt.data.get("inside", True):
        theta_y, theta_x = -np.pi / 4, 0.0
    else:
        theta_y, theta_x = np.pi / 4, np.pi / 2
    theta_z = np.pi / 4
    R_z = lie.angle_to_rotation_matrix(torch.tensor([theta_z]), "Z")[0].numpy()
    R_y = lie.angle_to_rotation_matrix(torch.tensor([theta_y]), "Y")[0].numpy()
    R_x = lie.angle_to_rotation_matrix(torch.tensor([theta_x]), "X")[0].numpy()
    w2c_rot = np.linalg.inv(R_x) @ np.linalg.inv(R_y) @ np.linalg.inv(R_z)
    t = w2c_rot @ np.asarray([
        -rad * np.cos(theta_y) * np.cos(theta_z),
        -rad * np.cos(theta_y) * np.sin(theta_z),
        -rad * np.sin(theta_y)], np.float64).reshape(3, 1)
    return np.concatenate([w2c_rot, t], axis=-1).astype(np.float32)


class Initializer:
    """Builds the first two Camera entities and runs the init phase."""

    def __init__(self, opt, cfgs: PhaseCfgs, cameraset: entities.CameraSet,
                 pointset: entities.PointSet, var: dict,
                 cam_info_reloaded: Optional[dict] = None, device=None):
        self.opt = opt
        self.cfgs = cfgs
        self.cameraset = cameraset
        self.pointset = pointset
        self.var = var
        self.device = resolve_device(device)

        id0, id1 = var["indx_init"]
        kp0_all, kp1_all = var["kypts_init"]
        matches0 = var["mchs_init"][0]
        inliers0 = var["inliers_init"][0]
        rel_id = id1 if id1 < id0 else id1 - 1
        m = matches0[rel_id].astype(np.int64)
        inl = inliers0[rel_id].astype(bool)
        self.kp_idx0 = m[inl, 0]
        self.kp_idx1 = m[inl, 1]
        kp0 = np.asarray(kp0_all)[self.kp_idx0]
        kp1 = np.asarray(kp1_all)[self.kp_idx1]
        intr = np.asarray(var["intrs_init"][0], np.float32)

        if cam_info_reloaded is None:
            w2c0 = bootstrap_cam0_pose(opt)
            tv = hostgeom.estimate_essential(kp0, kp1, intr)
            if not tv.success:
                raise RuntimeError("two-view essential-matrix estimation failed")
            self.essential = tv
            scale_init = scene_opt(opt, "scale_init", 1.0)
            rel = np.concatenate([tv.R, (tv.t * scale_init)[:, None]], axis=-1)
            w2c1 = lie.pose_compose_pair(_t(w2c0), _t(rel))
            se3_0 = lie.SE3_to_se3(_t(w2c0[None]))[0].numpy()
            se3_1 = lie.SE3_to_se3(w2c1[None])[0].numpy()
            extr = [se3_0, se3_1]
            idx2d = [None, None]
        else:
            extr = [cam_info_reloaded["pose_para"][i] for i in range(2)]
            idx2d = [cam_info_reloaded["idx2d_to_3ds"][i] for i in range(2)]

        for i, cam_id in enumerate((id0, id1)):
            cameraset.add(entities.Camera(
                id=cam_id,
                img=np.asarray(var["imgs_init"][i], np.float32),
                intr=np.asarray(var["intrs_init"][i], np.float32),
                pose_gt=np.asarray(var["poses_gt"][cam_id], np.float32),
                kypts=np.asarray(var["kypts_init"][i], np.float32),
                matches=var["mchs_init"][i],
                inlier_masks=var["inliers_init"][i],
                se3=np.asarray(extr[i], np.float32),
                idx2d_to_3d=None if idx2d[i] is None else np.asarray(idx2d[i])))

        oi = opt.optim.init
        weights = {k: v for k, v in opt.loss_weight.init.items()}
        self.phase = InitPhase(cfgs, weights,
                               lr_sdf=float(oi.lr_sdf), lr_sdf_end=float(oi.lr_sdf_end),
                               lr_color=float(oi.lr_color), max_iter=int(oi.max_iter))
        self.batch = self._build_batch()

    def _build_batch(self) -> dict:
        cam0, cam1 = self.cameraset.cameras[0], self.cameraset.cameras[1]
        H, W = self.cfgs.H, self.cfgs.W
        kp0 = cam0.kypts[self.kp_idx0]
        kp1 = cam1.kypts[self.kp_idx1]
        n = kp0.shape[0]
        pad = entities.pad_to_bucket(n)
        intr_np = np.asarray(cam0.intr, np.float32)

        def rays_for(pose, kps):
            c, r = T.get_center_and_ray(_t(pose)[None], _t(intr_np), _t(kps))
            return c[0].numpy(), r[0].numpy()

        c0, r0 = rays_for(cam0.pose(), kp0)
        c1, r1 = rays_for(cam1.pose(), kp1)

        def padded(x, fill=0.0):
            out = np.full((pad, *x.shape[1:]), fill, x.dtype)
            out[:n] = x
            return out

        center_k = np.stack([padded(c0), padded(c1)], 0)
        ray_k = np.stack([padded(r0), padded(r1)], 0)
        # a zero ray direction on padding would give NaNs in tracing
        ray_k[:, n:] = np.asarray([0.0, 0.0, 1.0])
        kp_src = np.stack([padded(kp1.astype(np.float32)),
                           padded(kp0.astype(np.float32))], 0)
        kp_mask = np.zeros((2, pad), bool)
        kp_mask[:, :n] = True
        images = np.stack([cam0.img.reshape(-1, 3), cam1.img.reshape(-1, 3)], 0)
        dev = self.device
        on = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
        self._n_kp = n
        return {
            "center_k": on(center_k), "ray_k": on(ray_k),
            "proj_pose": on(np.stack([cam1.pose(), cam0.pose()], 0)),
            "kp_src": on(kp_src), "kp_mask": on(kp_mask),
            "poses": on(np.stack([cam0.pose(), cam1.pose()], 0)),
            "intr": on(intr_np), "images": on(images),
            "grid": T.mesh_grid(H, W, device=dev),
        }

    def run(self, params, gen: torch.Generator, verbose: bool = True):
        """Optimize fields, triangulate, seed the point set. Returns params."""
        if self.opt.Ablate_config.get("tri_trad", False):
            return self.run_trad(params, gen, verbose=verbose)
        state = self.phase.init_state(params)
        state["opt"] = optstate.adopt("init", state["opt"])
        if self.cfgs.ren.compact_samples is not None:
            from .bundle import run_phase_occ_refresh
            state, metrics = run_phase_occ_refresh(
                self.opt, self.cfgs, self.phase, state, self.batch, gen,
                self.phase.max_iter, segments=8)
        else:
            state, metrics = self.phase.run(state, self.batch, gen)
        optstate.record("init", state["opt"])
        params = state["params"]
        self._metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        if verbose:
            last = {k: round(float(v[-1]), 4) for k, v in self._metrics.items()}
            print({"phase": "init", **last})
        pts_surface, finish = self.phase.triangulate(params, self.batch, gen)
        self._triangulate_host(pts_surface.cpu().numpy(), finish.cpu().numpy())
        if verbose:
            self._print_relpose_oracle()
        self.pose_errors = self.cameraset.eval_poses(verbose=verbose)
        return params

    def run_trad(self, params, gen: torch.Generator, verbose: bool = True):
        """``tri_trad``: DLT triangulation of the init pair's inliers, the
        points in front of both cameras and inside the bounds seeded, then
        the SDF fitted to them. Returns params."""
        from .trad import fit_sdf_to_points
        cam0, cam1 = self.cameraset.cameras[0], self.cameraset.cameras[1]
        pose0, pose1 = cam0.pose(), cam1.pose()
        X = hostgeom.triangulate_dlt(cam0.kypts[self.kp_idx0],
                                     cam1.kypts[self.kp_idx1],
                                     cam0.intr @ pose0, cam1.intr @ pose1)
        Xc0 = X @ pose0[:, :3].T + pose0[:, 3]
        Xc1 = X @ pose1[:, :3].T + pose1[:, 3]
        bmax = np.asarray(self.opt.data.bound_max, np.float32)
        bmin = np.asarray(self.opt.data.bound_min, np.float32)
        mask = ((Xc0[:, 2] > 0) & (Xc1[:, 2] > 0)
                & np.all(X < bmax, -1) & np.all(X > bmin, -1))
        self.tri_ratio = (int(mask.sum()), int(len(mask)))
        print(f"Triangulation ratio {mask.sum()}/{len(mask)}")
        kp_idx = np.stack([self.kp_idx0, self.kp_idx1], 0)[:, mask]
        tracks = [[(0, int(kp_idx[0, j])), (1, int(kp_idx[1, j]))]
                  for j in range(kp_idx.shape[1])]
        idx = self.pointset.add_points(X[mask], tracks)
        cam0.idx2d_to_3d[kp_idx[0]] = idx
        cam1.idx2d_to_3d[kp_idx[1]] = idx
        n = self._n_kp
        c = self.batch["center_k"][0, :n].cpu().numpy()[mask]
        r = self.batch["ray_k"][0, :n].cpu().numpy()[mask]
        params = fit_sdf_to_points(self.opt, self.cfgs, params, X[mask], c, r,
                                   gen, max_iter=200)
        self.pose_errors = self.cameraset.eval_poses(verbose=verbose)
        return params

    def _print_relpose_oracle(self):
        """The 5-point relative pose and the learned one against GT."""
        tv = getattr(self, "essential", None)
        if tv is None:
            return
        cam0, cam1 = self.cameraset.cameras[0], self.cameraset.cameras[1]
        rel_5pt = _t(np.concatenate([tv.R, tv.t[:, None]], -1))
        rel_gt = lie.pose_compose_pair(lie.pose_invert(_t(cam0.pose_gt)),
                                       _t(cam1.pose_gt))
        rel_est = lie.pose_compose_pair(lie.pose_invert(_t(cam0.pose())),
                                        _t(cam1.pose()))
        for name, rel in (("5 points algo", rel_5pt), ("our algo", rel_est)):
            r_err = float(np.rad2deg(float(
                lie.rotation_distance(rel_gt[:3, :3], rel[:3, :3]))))
            t_err = float(lie.translation_angle_deg(rel[:3, 3], rel_gt[:3, 3]))
            print(f"{name} rot_error:{r_err}")
            print(f"{name} translation_error:{t_err}")

    def _dump_match_vis(self, mask):
        """The init's match images (``output_path/init_mch/``): all pairs,
        and the pairs the filter dropped; a failure never stops the run."""
        out = self.opt.get("output_path", None)
        if not out:
            return
        try:
            import os
            from ..utils import vis
            cam0, cam1 = self.cameraset.cameras[:2]
            kp0 = cam0.kypts[self.kp_idx0]
            kp1 = cam1.kypts[self.kp_idx1]
            save = os.path.join(out, "init_mch")
            if (~mask).sum() > 2:
                vis.draw_matches(cam0.img, cam1.img, kp0[~mask], kp1[~mask],
                                 os.path.join(save, f"{cam0.id}_{cam1.id}_filter.png"),
                                 vis_num=100)
            vis.draw_matches(cam0.img, cam1.img, kp0, kp1,
                             os.path.join(save, f"{cam0.id}_{cam1.id}_org.png"))
        except Exception:
            pass

    def _triangulate_host(self, pts_surface, finish):
        """3-sigma + convergence filter, seed the PointSet."""
        n = self._n_kp
        p0, p1 = pts_surface[0, :n], pts_surface[1, :n]
        f0, f1 = finish[0, :n], finish[1, :n]
        diff = np.linalg.norm(p0 - p1, axis=-1)
        pts_avg = (p0 + p1) / 2
        gate = diff < (diff.mean() + 3 * diff.std())
        if self.opt.Ablate_config.get("sdf_filter", True):
            mask = gate & (f0 | f1)
        else:
            mask = gate
        self.tri_ratio = (int(mask.sum()), int(len(mask)))
        print(f"Triangulation ratio {mask.sum()}/{len(mask)}")
        self._dump_match_vis(mask)
        kp_idx = np.stack([self.kp_idx0, self.kp_idx1], 0)[:, mask]
        tracks = [[(0, int(kp_idx[0, j])), (1, int(kp_idx[1, j]))]
                  for j in range(kp_idx.shape[1])]
        idx = self.pointset.add_points(pts_avg[mask], tracks)
        self.cameraset.cameras[0].idx2d_to_3d[kp_idx[0]] = idx
        self.cameraset.cameras[1].idx2d_to_3d[kp_idx[1]] = idx
