"""New-view registration: covisibility gather, PnP, SDF triangulation.

Counterpart of ``level_s2fm_tpu/sfm/registration.py``: ``get_pairs``
collects 2D-3D matches through the track maps, ``pnp`` gates them by the
SDF value and solves the absolute pose (minigeom P3P RANSAC + LM), and
``geo_init`` runs ``GeoInitPhase`` (SDF-based triangulation) and accepts
new points by the tracing-distance mean + std threshold.
``score_candidates`` scores NBV candidates when ``nbv_mode`` is not
``colmap``. A registered view's PnP inliers are drawn into
``output_path/pnp/``. Under the ``tri_trad`` ablation ``geo_init``
DLT-triangulates the new view's untracked matches with each source view
instead (``geo_init_trad``).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..fields import sdf as sdf_mod
from ..geometry import lie, transforms as T
from . import entities, hostgeom, optstate
from .phases import GeoInitPhase, PhaseCfgs


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _sdf_gate(opt) -> float:
    # the ba_trad ablation widens the gate to a no-op
    return 5000.0 if opt.Ablate_config.get("ba_trad", False) else 0.05


def _pnp_max_error_px(opt) -> float:
    return float(opt.optim.get("pnp_max_error_px", 3.0))


def score_candidates(opt, cfgs: PhaseCfgs, params,
                     cameraset: entities.CameraSet, cams,
                     pointset: entities.PointSet):
    """NBV PnP scoring of every candidate with one covisibility sweep and
    one SDF eval over the concatenated candidate points; the same scores
    as ``Registration.pnp(if_nbv=False, dry_run=True)`` per candidate.
    Returns a list of (ok, inlier_ratio, inlier_count, n_src_views)."""
    entries, eval_slices, p3d_eval = [], [], []
    off = 0
    for ci, cam in enumerate(cams):
        reg = Registration(opt, cfgs, cameraset)
        pairs = reg.get_pairs(cam, pointset)
        if pairs is None:
            entries.append(None)
            continue
        p3d, p2d, _, _ = pairs
        entries.append((p3d, p2d, len(reg.src_cam_id)))
        if len(p3d) >= 100:  # <100 raw pairs short-circuits pre-SDF (pnp)
            eval_slices.append((ci, slice(off, off + len(p3d))))
            p3d_eval.append(p3d)
            off += len(p3d)
    sdfs_cat = (sdf_mod.infer_sdf_host(params["sdf"], cfgs.sdf,
                                       np.concatenate(p3d_eval))
                if p3d_eval else None)
    sdf_by_cand = {ci: sdfs_cat[sl] for ci, sl in eval_slices}
    results = []
    for ci, entry in enumerate(entries):
        if entry is None:
            results.append((False, 0.0, 0, 0))
            continue
        p3d, p2d, n_views = entry
        if len(p3d) < 100:
            results.append((False, 0.0, len(p3d), n_views))
            continue
        mask = sdf_by_cand[ci] < _sdf_gate(opt)
        p3d_m, p2d_m = p3d[mask], p2d[mask]
        res = hostgeom.pnp_ransac(p2d_m, p3d_m, cams[ci].intr,
                                  max_error_px=_pnp_max_error_px(opt))
        if not res.success:
            results.append((False, 0.0, 0, n_views))
            continue
        n_in = int(np.sum(res.inliers))
        results.append((n_in >= 100, n_in / max(len(p3d_m), 1), n_in, n_views))
    return results


class Registration:
    def __init__(self, opt, cfgs: PhaseCfgs, cameraset: entities.CameraSet):
        self.opt = opt
        self.cfgs = cfgs
        self.cameraset = cameraset
        self.src_cam_id: List[int] = []

    def get_pairs(self, new_cam: entities.Camera, pointset: entities.PointSet):
        """2D-3D correspondences for the new view from registered views:
        (p3d, p2d, point ids, new-view keypoint ids), one per keypoint."""
        pts_3d, pts_2d, id_3d, id_2d = [], [], [], []
        for cam_i in self.cameraset.cameras:
            self_idx, other_idx = cam_i.matched_kypt_ids(new_cam.id)
            if self_idx.size < 1:
                continue
            pts3d_idx = cam_i.idx2d_to_3d[self_idx]
            mask = pts3d_idx != -1
            if mask.sum() == 0:
                continue
            self.src_cam_id.append(cam_i.id)
            pts_3d.append(pointset.get_xyzs(pts3d_idx[mask]))
            pts_2d.append(new_cam.kypts[other_idx[mask]])
            id_3d.append(pts3d_idx[mask])
            id_2d.append(other_idx[mask])
        if len(id_2d) == 0:
            return None
        id_2d_u, org = np.unique(np.concatenate(id_2d), return_index=True)
        return (np.concatenate(pts_3d)[org], np.concatenate(pts_2d)[org],
                np.concatenate(id_3d)[org], id_2d_u)

    def pnp(self, params, camera_new: entities.Camera, pointset: entities.PointSet,
            if_nbv: bool = False, dry_run: bool = False,
            min_inliers: int = 0,
            min_inlier_ratio: float = 0.0) -> Tuple[bool, float, int]:
        """SDF-gated PnP RANSAC + refinement. Returns (success,
        inlier_ratio, inlier_count). Below 100 raw pairs or inliers it
        fails unless ``if_nbv``; ``min_inliers`` / ``min_inlier_ratio``
        reject before any scene state changes; ``dry_run`` scores without
        touching the scene state."""
        pairs = self.get_pairs(camera_new, pointset)
        if pairs is None:
            return False, 0.0, 0
        p3d, p2d, id_3d, id_2d = pairs
        if (len(p3d) < 100) and not if_nbv:
            return False, 0.0, len(p3d)
        sdfs = sdf_mod.infer_sdf_host(params["sdf"], self.cfgs.sdf, p3d)
        n_nonfinite_sdf = int(np.sum(~np.isfinite(sdfs)))
        if n_nonfinite_sdf:
            print(f"WARNING: SDF returned {n_nonfinite_sdf}/{len(sdfs)} "
                  f"non-finite values at PnP filtering — field params are "
                  f"likely NaN-poisoned")
        mask = sdfs < _sdf_gate(self.opt)
        p3d_m, p2d_m = p3d[mask], p2d[mask]
        res = hostgeom.pnp_ransac(p2d_m, p3d_m, camera_new.intr,
                                  max_error_px=_pnp_max_error_px(self.opt))
        if not res.success:
            print(f"registration fail# image{camera_new.id} "
                  f"(pairs={len(p3d)}, sdf_gated={len(p3d_m)}, "
                  f"nonfinite_sdf={n_nonfinite_sdf}, "
                  f"src_views={len(self.src_cam_id)})")
            return False, 0.0, 0
        id_2d_in = id_2d[mask][res.inliers]
        id_3d_in = id_3d[mask][res.inliers]
        print(f"PnP: {len(id_3d)} (found), {len(p3d_m)} (masked), "
              f"{len(id_2d_in)} (inliers)")
        ratio = len(id_2d_in) / max(len(p3d_m), 1)
        if (len(id_2d_in) < 100) and not if_nbv:
            return False, ratio, len(id_2d_in)
        if len(id_2d_in) < min_inliers:
            print(f"registration weak# image{camera_new.id} "
                  f"({len(id_2d_in)} inliers < min_inliers={min_inliers})")
            return False, ratio, len(id_2d_in)
        if ratio < min_inlier_ratio:
            print(f"registration weak# image{camera_new.id} "
                  f"(inlier ratio {ratio:.2f} = {len(id_2d_in)}/{len(p3d_m)}"
                  f" < min_inlier_ratio={min_inlier_ratio})")
            return False, ratio, len(id_2d_in)
        if dry_run:
            return True, ratio, len(id_2d_in)
        SE3 = np.concatenate([res.R, res.t.reshape(3, 1)], axis=-1)
        camera_new.se3 = lie.SE3_to_se3(_t(SE3[None]))[0].numpy().copy()
        new_cam_pos = len(self.cameraset)  # position the new camera will take
        pointset.update_feat_tracks(id_3d_in,
                                    [(new_cam_pos, int(k)) for k in id_2d_in])
        camera_new.idx2d_to_3d[id_2d_in] = id_3d_in
        self._dump_pnp_overlay(camera_new, id_2d_in)
        return True, ratio, len(id_2d_in)

    def _dump_pnp_overlay(self, camera_new, id_2d_in):
        """The PnP inlier keypoints drawn over the new view
        (``output_path/pnp/pnp_<n>.png``); a failure never stops the run."""
        out = self.opt.get("output_path", None)
        if not out:
            return
        try:
            import os
            from ..utils import vis
            vis.draw_keypoints(
                camera_new.img, camera_new.kypts[id_2d_in],
                os.path.join(out, "pnp", f"pnp_{len(self.cameraset)}.png"))
        except Exception:
            pass

    def _pair_rays(self, cam_from: entities.Camera, cam_with: entities.Camera):
        """Rays from cam_from through its inlier kypts matched with
        cam_with, the targets in cam_with and cam_from's kypt indices."""
        self_idx, other_idx = cam_from.matched_kypt_ids(cam_with.id)
        c, r = T.get_center_and_ray(_t(cam_from.pose())[None], _t(cam_from.intr),
                                    _t(cam_from.kypts[self_idx]))
        return (c[0].numpy(), r[0].numpy(),
                cam_with.kypts[other_idx].astype(np.float32), self_idx)

    def geo_init_batch(self, camera_new: entities.Camera,
                       pointset: entities.PointSet, verbose=True):
        """(segments, host batch) of geoinit, or (None, None) when no
        source view shares matches. The pair rays are capped at
        ``optim.geoinit.max_rays`` by a proportional subsample seeded
        from the scene state."""
        segs = []
        for src_id in self.src_cam_id:
            cam_i = self.cameraset(src_id)
            c0, r0, kp_in_src, kidx_new = self._pair_rays(camera_new, cam_i)
            c1, r1, kp_in_new, kidx_src = self._pair_rays(cam_i, camera_new)
            n = c0.shape[0]
            assert c1.shape[0] == n, "match lists must be symmetric"
            segs.append(dict(c0=c0, r0=r0, c1=c1, r1=r1,
                             kp0=kp_in_src, kp1=kp_in_new,
                             kidx_new=kidx_new, kidx_src=kidx_src,
                             pose_src=cam_i.pose(), n=n,
                             cam_pair=(self.cameraset.index_of(camera_new.id),
                                       self.cameraset.index_of(src_id))))
        if not segs:
            return None, None
        P_real = sum(s["n"] for s in segs)
        cap = int(self.opt.optim.geoinit.get("max_rays", 0) or 0)
        if cap and P_real > cap:
            rng = np.random.default_rng(
                1000003 * int(camera_new.id) + len(pointset))
            # proportional quotas that sum to at most the cap
            quotas = [min(max(int(s["n"] * cap // P_real), 1), s["n"])
                      for s in segs]
            over = sum(quotas) - cap
            for qi in sorted(range(len(quotas)), key=lambda q: -quotas[q]):
                if over <= 0:
                    break
                give = min(over, quotas[qi] - 1)
                quotas[qi] -= give
                over -= give
            for s, k in zip(segs, quotas):
                sel = np.sort(rng.choice(s["n"], size=k, replace=False))
                for kk in ("c0", "r0", "c1", "r1", "kp0", "kp1",
                           "kidx_new", "kidx_src"):
                    s[kk] = s[kk][sel]
                s["n"] = k
            if verbose:
                print(f"[geoinit] ray budget: {P_real} pair rays "
                      f"subsampled to {sum(s['n'] for s in segs)} "
                      f"(max_rays={cap})")
            P_real = sum(s["n"] for s in segs)
        P = entities.pad_to_bucket(P_real)
        f32 = np.float32
        center = np.zeros((2, P, 3), f32)
        ray = np.zeros((2, P, 3), f32)
        ray[..., 2] = 1.0  # benign padding direction
        kp_src = np.zeros((2, P, 2), f32)
        pose0 = np.broadcast_to(np.eye(3, 4, dtype=f32), (P, 3, 4)).copy()
        pose1 = pose0.copy()
        seg_ids = np.zeros(P, np.int64)
        valid = np.zeros(P, bool)
        mask_new = np.zeros(P, bool)
        xyz_target = np.zeros((P, 3), f32)
        has_target = np.zeros(P, bool)
        pose_new = camera_new.pose()
        off = 0
        for si, s in enumerate(segs):
            sl = slice(off, off + s["n"])
            center[0, sl], ray[0, sl] = s["c0"], s["r0"]
            center[1, sl], ray[1, sl] = s["c1"], s["r1"]
            kp_src[0, sl], kp_src[1, sl] = s["kp0"], s["kp1"]
            pose0[sl] = s["pose_src"]
            pose1[sl] = pose_new
            seg_ids[sl] = si
            valid[sl] = True
            idx3d = camera_new.idx2d_to_3d[s["kidx_new"]]
            s["is_new"] = idx3d == -1
            mask_new[sl] = s["is_new"]
            tracked = ~s["is_new"]
            if tracked.any():
                rows = np.arange(off, off + s["n"])[tracked]
                xyz_target[rows] = pointset.get_xyzs(idx3d[tracked])
                has_target[rows] = True
            off += s["n"]
        E = entities.pad_to_bucket(max(len(pointset), 1))
        pts_exists = np.zeros((E, 3), f32)
        pts_exists[:len(pointset)] = pointset.all_xyzs()
        pts_mask = np.zeros(E, bool)
        # points retired by observation pruning stay out of the exist loss
        pts_mask[:len(pointset)] = pointset.alive_mask() if len(pointset) else True
        batch = {"center": center, "ray": ray, "kp_src": kp_src,
                 "pose0": pose0, "pose1": pose1, "seg": seg_ids,
                 "valid": valid, "mask_new": mask_new,
                 "xyz_target": xyz_target, "has_target": has_target,
                 "pts_exists": pts_exists, "pts_mask": pts_mask,
                 "intr": np.asarray(camera_new.intr, f32)}
        return segs, batch

    def geo_init(self, params, camera_new: entities.Camera,
                 pointset: entities.PointSet, gen: torch.Generator,
                 verbose=True, reproj_max: float = None):
        """SDF-based triangulation of the new view's observations:
        ``optim.geoinit.max_iter`` x 5 GeoInitPhase steps, then the
        accepted points join the point set. ``reproj_max``
        (``optim.geoinit.reproj_max``, default 15 px) sets the two-sided
        rejection gates rmax / 2 rmax / 4 rmax."""
        opt = self.opt
        if opt.Ablate_config.get("tri_trad", False):
            return self.geo_init_trad(params, camera_new, pointset, gen,
                                      verbose=verbose)
        if reproj_max is None:
            reproj_max = float(opt.optim.geoinit.get("reproj_max", 15.0))
        segs, host = self.geo_init_batch(camera_new, pointset, verbose)
        if segs is None:
            return params
        dev = params["sdf"]["table"].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
        og = opt.optim.geoinit
        phase = GeoInitPhase(
            self.cfgs, dict(opt.loss_weight.geoinit),
            n_segments=entities.pad_to_bucket(len(segs),
                                              buckets=(2, 4, 8, 16, 32, 64)),
            lr_sdf=float(og.lr_sdf), lr_sdf_end=float(og.lr_sdf_end),
            max_iter=int(og.max_iter) * 5, reproj_max=reproj_max)
        self.phase, self.batch = phase, batch
        state = phase.init_state(params)
        state["opt"] = optstate.adopt("geoinit", state["opt"])
        state, metrics = phase.run(state, batch, gen)
        optstate.record("geoinit", state["opt"])
        self.metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        params = state["params"]
        if verbose:
            print({"phase": "geoinit", **{k: round(float(v[-1]), 4)
                                          for k, v in self.metrics.items()}})
        fin = phase.final(params, batch, gen)
        self._accept_points({k: v.cpu().numpy() for k, v in fin.items()},
                            segs, camera_new, pointset, verbose)
        return params

    def geo_init_trad(self, params, camera_new: entities.Camera,
                      pointset: entities.PointSet, gen: torch.Generator,
                      verbose=True, reproj_max: float = None):
        """``tri_trad``: DLT triangulation of the new view's untracked
        matches with each source view; a point is kept when it reprojects
        within ``optim.geoinit.reproj_max_trad`` (default 8 px) in both
        views and lies in front of both. Unless ``ba_trad`` is on, the SDF
        is then fitted to the new points (100 steps). Returns params."""
        from .trad import fit_sdf_to_points
        if reproj_max is None:
            reproj_max = float(self.opt.optim.geoinit.get("reproj_max_trad", 8.0))
        new_pos = self.cameraset.index_of(camera_new.id)
        pose_n, K_n = camera_new.pose(), camera_new.intr
        all_new_pts, all_c, all_r = [], [], []
        self.tri_ratio = [0, 0]
        for src_id in self.src_cam_id:
            cam_i = self.cameraset(src_id)
            kn, ko = camera_new.matched_kypt_ids(src_id)
            is_new = camera_new.idx2d_to_3d[kn] == -1
            if is_new.sum() == 0:
                continue
            kn, ko = kn[is_new], ko[is_new]
            kp_n, kp_s = camera_new.kypts[kn], cam_i.kypts[ko]
            X = hostgeom.triangulate_dlt(kp_n, kp_s, K_n @ pose_n,
                                         cam_i.intr @ cam_i.pose())
            uv_n, z_n = T.project_points(_t(X)[None], _t(pose_n)[None],
                                         _t(K_n)[None])
            uv_s, z_s = T.project_points(_t(X)[None], _t(cam_i.pose())[None],
                                         _t(cam_i.intr)[None])
            re_n = np.linalg.norm(uv_n[0].numpy() - kp_n, axis=-1)
            re_s = np.linalg.norm(uv_s[0].numpy() - kp_s, axis=-1)
            ok = ((re_n < reproj_max) & (re_s < reproj_max)
                  & (z_n[0, :, 0].numpy() > 0) & (z_s[0, :, 0].numpy() > 0))
            self.tri_ratio[0] += int(ok.sum())
            self.tri_ratio[1] += len(ok)
            if verbose:
                print(f"the new triangulation ratio:{ok.sum()}/{len(ok)}")
            if ok.sum() == 0:
                continue
            tracks = [[(new_pos, int(a)), (self.cameraset.index_of(src_id), int(b))]
                      for a, b in zip(kn[ok], ko[ok])]
            idx = pointset.add_points(X[ok], tracks)
            camera_new.idx2d_to_3d[kn[ok]] = idx
            cam_i.idx2d_to_3d[ko[ok]] = idx
            all_new_pts.append(X[ok])
            c, r = T.get_center_and_ray(_t(pose_n)[None], _t(K_n),
                                        _t(camera_new.kypts[kn[ok]]))
            all_c.append(c[0].numpy())
            all_r.append(r[0].numpy())
        if all_new_pts and not self.opt.Ablate_config.get("ba_trad", False):
            params = fit_sdf_to_points(self.opt, self.cfgs, params,
                                       np.concatenate(all_new_pts),
                                       np.concatenate(all_c),
                                       np.concatenate(all_r), gen, max_iter=100)
        return params

    def _accept_points(self, fin, segs, camera_new, pointset, verbose):
        """Tracing-distance mean + std acceptance of new triangulations."""
        pts, finish, reject = fin["pts"], fin["finish"], fin["reject"]
        rec = fin["trace_dist"][fin["trace_mask"]]
        threshold = rec.mean() + rec.std() if rec.size else np.inf
        self.tri_ratio = [0, 0]
        off = 0
        for s in segs:
            sl = slice(off, off + s["n"])
            # the mask of the batch, from before this call's updates
            keep = s["is_new"] & ~reject[sl]
            p0, p1 = pts[0, sl][keep], pts[1, sl][keep]
            f0, f1 = finish[0, sl][keep], finish[1, sl][keep]
            acc = (np.linalg.norm(p0 - p1, axis=-1) <= threshold) | (f0 & f1)
            self.tri_ratio[0] += int(acc.sum())
            self.tri_ratio[1] += len(acc)
            if verbose:
                print(f"the new triangulation ratio:{acc.sum()}/{len(acc)}")
            kidx_new = s["kidx_new"][keep][acc]
            kidx_src = s["kidx_src"][keep][acc]
            cam_new_pos, cam_src_pos = s["cam_pair"]
            tracks = [[(cam_new_pos, int(a)), (cam_src_pos, int(b))]
                      for a, b in zip(kidx_new, kidx_src)]
            if len(tracks):
                idx = pointset.add_points(((p0 + p1) / 2)[acc], tracks)
                self.cameraset.cameras[cam_new_pos].idx2d_to_3d[kidx_new] = idx
                self.cameraset.cameras[cam_src_pos].idx2d_to_3d[kidx_src] = idx
            off += s["n"]
