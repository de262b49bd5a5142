"""Incremental SfM orchestrator — the engine state machine.

Counterpart of ``LevelSfM`` in ``level_s2fm_tpu/sfm/pipeline.py``:
two-view init, then per view: NBV selection (colmap order or PnP
scoring), PnP registration, SDF triangulation (geoinit), sfm_refine ->
local BA -> global BA cycles with the reprojection gates (2.5 px / 1.0
px, cycle caps 1/5/5), the rendering refine, and the per-view metrics
row. ``train`` ends cleanly when every view is registered, defers failed
views (``registration.max_attempts`` > 1) and stops when a retry could
only fail again. The field parameters are updated in place, so the
rollback points (the BA guard, the non-finite field check) hold copies.
After the init and after every registered view a checkpoint is written
(``model.ckpt``, and ``model_<it>.ckpt`` every ``freq.ckpt`` views); a
restored checkpoint rebuilds the scene (``_reload_scene``) and the run
goes on from there. Each view's row goes to ``metrics.jsonl`` with the
JAX package's keys; ``freq.vis`` dumps per-view artifacts, and the end of
the run writes the point cloud, cameras and viewer page and, when the
scene has GT depth, the depth evaluation. Under data-parallel ranks
(``parallel``) every rank runs the engine: the phases shard their rows,
and the host decisions (the next view, PnP, the guards) are made on
rank 0 and broadcast, with rank 0's scene taken by every rank after the
init, PnP, geoinit and each view (``entities.sync_scene``); only rank 0
writes files. Under the ``ba_trad``
ablation a view's BA is one local and one global ``TradBundler`` (free
points, reprojection only) and nothing more; unlike the JAX package,
which returns before its metrics row there, the view's row is written.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..fields import radiance as radf
from ..fields import sdf as sdf_mod
from ..parallel import distributed as pdist
from ..rendering import renderer as ren_mod
from ..utils import checkpoint as ckpt_mod
from ..utils.obs import HOST_TIMERS, Log, MetricRecorder, PhaseTimers
from . import entities
from .bundle import Bundler, Refiner
from .initialization import Initializer
from .phases import PhaseCfgs
from .registration import Registration, score_candidates


def clone_params(tree):
    """A detached copy of a parameter tree (a rollback point)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_params(v) for k, v in tree.items()}
    return [clone_params(v) for v in tree]


class LevelSfM:
    """Top-level model/engine. ``device`` defaults to ``cuda``."""

    def __init__(self, opt, seed: int = 0, device=None):
        self.opt = opt
        self.device = resolve_device(device)
        self.sdf_cfg = sdf_mod.config_from_opt(opt)
        self.rad_cfg = radf.config_from_opt(opt)
        self.ren_cfg = ren_mod.config_from_opt(opt)
        H, W = opt.data.image_size
        dcw = opt.data.get("unfinish_dc", None)
        dataset = opt.data.get("dataset", None)
        in_list = dataset in ["TanksAndTemple", "BlendedMVS", "scannet", "DTU",
                              "llff", "ETH3D", "ETH3D_sp", None, "synthetic"]
        self.cfgs = PhaseCfgs(sdf=self.sdf_cfg, rad=self.rad_cfg, ren=self.ren_cfg,
                              H=H, W=W,
                              rand_rays=int(opt.Renderer.rand_rays),
                              dc_unfinish_weight=None if in_list else dcw)
        init_gen = torch.Generator().manual_seed(seed)
        self.params = {
            "sdf": sdf_mod.init_params(self.sdf_cfg, init_gen, device=self.device),
            "rad": radf.init_params(self.rad_cfg, init_gen, device=self.device)}
        self.gen = torch.Generator().manual_seed(seed + 1)
        self.camera_set = entities.CameraSet()
        self.point_set = entities.PointSet()
        self.var: Optional[Dict] = None
        self.it = 0
        self.cam_info_reloaded = None
        self.pts_info_reloaded = None
        self.initializer: Optional[Initializer] = None
        #: one dict per registered view (the metrics row, the stage
        #: timings and what PnP / geoinit / BA reported)
        self.view_log: List[Dict] = []
        self.skipped_views: List[int] = []
        #: called as hook(stage, obj) after each stage of a registration
        #: (geo_init: the Registration; sfm_refine, local_ba, global_ba:
        #: the Bundler; refine: the Refiner), for probes and profiling
        self.stage_hook = None
        out = opt.get("output_path", None)
        self.metrics = MetricRecorder(
            os.path.join(out, "metrics.jsonl") if out else None,
            tb_dir=(os.path.join(out, "tb") if out and opt.get("tb", False)
                    else None))
        self.timers = PhaseTimers()

    def load_data(self, var: Dict):
        """var: kypts, matches, masks, poses_gt, images, intrs, pose_graph."""
        self.var = var

    def next_key(self) -> torch.Generator:
        """A fresh CPU generator, seeded from the engine's stream."""
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.gen))
        return torch.Generator().manual_seed(seed)

    # ------------------------------------------------------------ checkpoints
    def ckpt_path(self, numbered: Optional[int] = None) -> str:
        out = self.opt.get("output_path", "output/run")
        if numbered is None:
            return os.path.join(out, "model.ckpt")
        return os.path.join(out, f"model_{numbered}.ckpt")

    def save_checkpoint(self, latest=True):
        """Write ``model.ckpt``; with ``latest=False`` also ``model_<it>.ckpt``."""
        ckpt_mod.save_checkpoint_sfm(self.ckpt_path(), self.params,
                                     self.camera_set, self.point_set, it=self.it)
        if not latest:
            ckpt_mod.save_checkpoint_sfm(self.ckpt_path(self.it), self.params,
                                         self.camera_set, self.point_set,
                                         it=self.it)

    def restore_checkpoint(self, path: Optional[str] = None):
        """Load parameters, camera and point state and the iteration count;
        the scene itself is rebuilt by ``_reload_scene`` (``train`` calls
        it)."""
        path = path or self.ckpt_path()
        with HOST_TIMERS.track("host_restore"):
            params, cam_info, pts_info, it = ckpt_mod.restore_checkpoint_sfm(
                path, device=self.device)
        self.params = params
        self.cam_info_reloaded = cam_info
        self.pts_info_reloaded = pts_info
        self.it = it

    def _reload_scene(self):
        """Rebuild the CameraSet and PointSet from a restored checkpoint."""
        info = self.cam_info_reloaded
        self.point_set.add_points(np.asarray(self.pts_info_reloaded["xyzs"]),
                                  self.pts_info_reloaded["feat_tracks"])
        for k, cam_id in enumerate(info["cam_id"]):
            cam = self._make_camera(int(cam_id))
            cam.se3 = np.array(info["pose_para"][k], np.float32)
            cam.idx2d_to_3d = np.array(info["idx2d_to_3ds"][k], np.int64)
            self.camera_set.add(cam)

    def _make_camera(self, cam_id: int) -> entities.Camera:
        var = self.var
        return entities.Camera(
            id=cam_id,
            img=np.asarray(var["images"][cam_id], np.float32),
            intr=np.asarray(var["intrs"][cam_id], np.float32),
            pose_gt=np.asarray(var["poses_gt"][cam_id], np.float32),
            kypts=np.asarray(var["kypts"][cam_id], np.float32),
            matches=var["matches"][cam_id],
            inlier_masks=var["masks"][cam_id])

    # ------------------------------------------------------------ phases
    def initialize_two_views(self, id0: int, id1: int, verbose=True):
        var = self.var
        init_var = {
            "indx_init": [id0, id1],
            "imgs_init": [var["images"][id0], var["images"][id1]],
            "kypts_init": [var["kypts"][id0], var["kypts"][id1]],
            "intrs_init": [var["intrs"][id0], var["intrs"][id1]],
            "mchs_init": [var["matches"][id0], var["matches"][id1]],
            "inliers_init": [var["masks"][id0], var["masks"][id1]],
            "poses_gt": var["poses_gt"],
        }
        self.initializer = Initializer(
            self.opt, self.cfgs, self.camera_set, self.point_set, init_var,
            cam_info_reloaded=self.cam_info_reloaded, device=self.device)
        if self.cam_info_reloaded is None:
            self.params = self.initializer.run(self.params, self.next_key(),
                                               verbose=verbose)
            entities.sync_scene(self.camera_set, self.point_set)

    def select_next_view(self, pose_graph_left, verbose=True) -> int:
        """NBV: colmap order, or the PnP inlier score of every candidate
        (ratio x min(views, 10) + count / max count)."""
        if self.opt.get("nbv_mode", "colmap") == "colmap":
            return pose_graph_left[0]
        cands = [self._make_camera(c) for c in pose_graph_left]
        scored = score_candidates(self.opt, self.cfgs, self.params,
                                  self.camera_set, cands, self.point_set)
        nums = np.asarray([s[2] for s in scored], np.float64)
        score = (np.asarray([s[1] for s in scored])
                 * np.clip(np.asarray([s[3] for s in scored]), 0, 10)
                 + nums / max(nums.max(), 1))
        return pose_graph_left[int(np.argmax(score))]

    def _prune_observations(self, verbose=True, reproj: float = None):
        """Post-BA outlier-observation pruning, gated by
        ``optim.prune.reproj_max`` (px; 0 = off). Skipped when the calling
        BA cycle's mean reprojection is itself above the gate."""
        pr = self.opt.optim.get("prune", {})
        thr = float(pr.get("reproj_max", 0.0) or 0.0)
        if thr <= 0.0:
            return
        if reproj is not None and (not np.isfinite(reproj) or reproj > thr):
            if verbose:
                print(f"[prune] skipped: mean reproj {reproj:.2f}px above "
                      f"the {thr}px gate (diverged state)")
            return
        n_rm, n_ret = entities.prune_outlier_observations(
            self.camera_set, self.point_set, thr_px=thr,
            min_track=int(pr.get("min_track", 2)),
            max_cam_frac=float(pr.get("max_cam_frac", 0.25)))
        if verbose and (n_rm or n_ret):
            print(f"[prune] dropped {n_rm} observations > {thr}px, "
                  f"retired {n_ret} points")

    def _ba_guard_pre(self, cam_ids):
        """Rollback point of one BA cycle when the divergence guard is on
        (``optim.ba_guard.factor`` > 0). Returns (pre_mean_reproj_px,
        geometry_snapshot, params_copy)."""
        g = self.opt.optim.get("ba_guard", {})
        if float(g.get("factor", 0.0) or 0.0) <= 0.0:
            return None, None, None
        pre = entities.mean_reprojection_px(self.camera_set, self.point_set,
                                            cam_ids)
        snap = entities.snapshot_geometry(self.camera_set, self.point_set)
        return pre, snap, clone_params(self.params)

    def _ba_guard_post(self, label, pre, snap, params_pre, cam_ids,
                       verbose=True) -> bool:
        """Roll one BA cycle back when it diverged: post-cycle mean
        reprojection non-finite, or worse than ``factor`` x the pre-cycle
        value and above ``px_min``. Returns True when rolled back."""
        if snap is None:
            return False
        g = self.opt.optim.get("ba_guard", {})
        factor = float(g.get("factor", 2.0))
        px_min = float(g.get("px_min", 2.0))
        post = entities.mean_reprojection_px(self.camera_set, self.point_set,
                                             cam_ids)
        diverged = pdist.broadcast_object((not np.isfinite(post)) or (
            np.isfinite(pre) and post > max(factor * pre, px_min)))
        if diverged:
            entities.restore_geometry(self.camera_set, self.point_set, snap)
            self.params = params_pre
            if verbose:
                print(f"[ba-guard] {label} cycle diverged "
                      f"({pre:.2f} -> {post:.2f}px); rolled back")
            return True
        return False

    def _finite_params_or_revert(self, label: str, params_prev) -> bool:
        """If any field parameter went non-finite, revert to the copy
        taken before the phase. Returns True when healthy."""
        from .optim import tree_leaves
        ok = pdist.broadcast_object(bool(torch.stack(
            [torch.isfinite(p).all() for p in tree_leaves(self.params)]).all()))
        if not ok:
            print(f"WARNING: [field-guard] non-finite field params after "
                  f"{label}; reverting to pre-phase params")
            self.params = params_prev
        return ok

    def register_view(self, new_id: int, verbose=True) -> bool:
        """PnP + geoinit + BA cycles (+ refine in full mode) for one view."""
        opt = self.opt
        row: Dict = {"view": new_id, "stage_s": {}}
        timers = row["stage_s"]

        def timed(name, fn):
            with self.timers.track(name, into=timers):
                out = fn()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            return out

        camera_new = self._make_camera(new_id)
        reg = Registration(opt, self.cfgs, self.camera_set)
        reg_cfg = opt.get("registration", {})
        ok, ratio, num = timed("pnp", lambda: pdist.on_primary(lambda: reg.pnp(
            self.params, camera_new, self.point_set, if_nbv=True,
            min_inliers=int(reg_cfg.get("min_inliers", 0)),
            min_inlier_ratio=float(reg_cfg.get("min_inlier_ratio", 0.0)))))
        reg.src_cam_id = pdist.broadcast_object(reg.src_cam_id)
        entities.sync_scene(self.camera_set, self.point_set, [camera_new])
        row["pnp_inliers"], row["pnp_ratio"] = num, ratio
        self.camera_set.eval_poses(verbose=verbose)
        if not ok:
            print("reconstruct fail")
            return False
        self.camera_set.add(camera_new)
        params_pre = clone_params(self.params)
        self.params = timed("geo_init", lambda: reg.geo_init(
            self.params, camera_new, self.point_set, self.next_key(),
            verbose=verbose))
        self._finite_params_or_revert("geo_init", params_pre)
        entities.sync_scene(self.camera_set, self.point_set)
        row["triangulated"] = getattr(reg, "tri_ratio", [0, 0])
        self._probe("geo_init", reg)
        src_cam_id = reg.src_cam_id

        def bundle(stage, ids, mode):
            b = Bundler(opt, self.cfgs, self.camera_set, self.point_set,
                        cam_pick_ids=ids, mode=mode, device=self.device)
            self.params, reproj = timed(stage, lambda: b.run(
                self.params, self.next_key(), verbose))
            self._probe(stage, b)
            return reproj

        if opt.Ablate_config.get("ba_trad", False):
            return self._trad_bundle(row, new_id, src_cam_id, timed, verbose)

        full = opt.get("sfm_mode", "full") == "full"
        if full:
            # reproj + rendering registration refine of the new camera
            reproj, cycle = 100.0, 0
            while reproj > 2.5 and cycle < 1:
                params_pre = clone_params(self.params)
                reproj = bundle("sfm_refine", [new_id], "sfm_refine")
                self._finite_params_or_revert("sfm_refine", params_pre)
                self.camera_set.eval_poses(src_cam_id + [new_id], verbose=verbose)
                cycle += 1
        # local BA cycles
        reproj, cycle = 100.0, 0
        measured_reproj = None  # last measured mean reproj (None = never)
        local_ids = [new_id] + src_cam_id
        while reproj > 1.0 and cycle < 5:
            pre, snap, params_pre = self._ba_guard_pre(local_ids)
            reproj = bundle("local_ba", local_ids, "sfm")
            if self._ba_guard_post("local BA", pre, snap, params_pre, local_ids,
                                   verbose):
                reproj = measured_reproj = pre
                break
            measured_reproj = reproj
            self.camera_set.eval_poses(src_cam_id + [new_id], verbose=verbose)
            cycle += 1
            # from cycle 2 the new pose has settled: prune inside the loop
            if cycle >= 2:
                self._prune_observations(verbose, reproj)
        self._prune_observations(verbose, measured_reproj)
        # global BA cycles
        reproj, cycle = 100.0, 0
        while reproj > 1.0 and cycle < 5:
            pre, snap, params_pre = self._ba_guard_pre(None)
            reproj = bundle("global_ba", None, "sfm")
            if self._ba_guard_post("global BA", pre, snap, params_pre, None,
                                   verbose):
                reproj = pre
                break
            self.camera_set.eval_poses(verbose=verbose)
            cycle += 1
            self._prune_observations(verbose, reproj)
        if full:
            params_pre = clone_params(self.params)
            r = Refiner(opt, self.cfgs, self.camera_set, self.point_set,
                        device=self.device)
            self.params = timed("refine", lambda: r.run(
                self.params, self.next_key(), verbose))
            self._finite_params_or_revert("refine", params_pre)
            self._probe("refine", r)
        return self._log_view(row, reproj)

    def _trad_bundle(self, row, new_id, src_cam_id, timed, verbose) -> bool:
        """``ba_trad``: one local (the new view and its sources) and one
        global ``TradBundler``, with the pose errors after each."""
        from .trad import TradBundler
        reproj = None
        for stage, pick in (("local_ba", [new_id] + src_cam_id),
                            ("global_ba", None)):
            b = TradBundler(self.opt, self.cfgs, self.camera_set, self.point_set,
                            cam_pick_ids=pick, device=self.device)
            self.params, reproj = timed(stage, lambda: b.run(
                self.params, self.next_key(), verbose))
            self._probe(stage, b)
            self.camera_set.eval_poses(verbose=verbose)
        return self._log_view(row, reproj)

    def _log_view(self, row, reproj) -> bool:
        """Complete a registered view's row with the pose errors, keep it
        in ``view_log`` and write it to the metrics."""
        entities.sync_scene(self.camera_set, self.point_set)
        r_deg, t_err, ate = self.camera_set.eval_poses(verbose=False)
        row.update(n_cams=len(self.camera_set), n_points=len(self.point_set),
                   reproj_px=reproj, rot_err_deg=r_deg, t_err=t_err, ate=ate)
        self.view_log.append(row)
        keys = ("view", "n_cams", "n_points", "reproj_px", "rot_err_deg",
                "t_err", "ate")
        self.metrics.log(self.it, **{k: row[k] for k in keys})
        print({k: row[k] for k in keys})
        return True

    def _probe(self, stage, obj):
        if self.stage_hook is not None:
            self.stage_hook(stage, obj)

    # ------------------------------------------------------------ main loop
    def train(self, verbose=True, max_views: Optional[int] = None):
        """Two-view init, then register views until every view of the
        pose graph is in, ``max_views`` is reached, or the remaining views
        cannot register. Returns False on the reference-parity abort
        (first failure with ``registration.max_attempts`` = 1)."""
        pose_graph = list(self.var["pose_graph"])
        n_img = len(self.var["images"])
        if len(pose_graph) <= n_img / 2:
            pose_graph = pose_graph + [j for j in range(n_img) if j not in pose_graph]
        if self.cam_info_reloaded is not None:
            self._reload_scene()
            print("reloading finished")
        # a failed view is deferred until another view registers (new
        # points give it new 2D-3D pairs) and retried up to max_attempts
        # times; PnP is seeded, so a retry against an unchanged scene
        # would fail again, and the run stops instead
        max_attempts = int(self.opt.get("registration", {}).get("max_attempts", 1))
        fail_counts: Dict[int, int] = {}
        deferred: set = set()
        while True:
            if max_views is not None and len(self.camera_set) >= max_views:
                break
            if len(self.camera_set) < 2:
                ids = (self.cam_info_reloaded["cam_id"][:2]
                       if self.cam_info_reloaded is not None else pose_graph[:2])
                with self.timers.track("init"):
                    self.initialize_two_views(ids[0], ids[1], verbose=verbose)
                self.save_checkpoint(latest=False)
                continue
            left = [p for p in pose_graph if p not in self.camera_set.cam_ids]
            print(f"---------------- {len(left)} frames left ------------------")
            if not left:
                print("finish!")
                break
            retryable = [p for p in left if fail_counts.get(p, 0) < max_attempts]
            eligible = [p for p in retryable if p not in deferred]
            if not eligible:
                why = ("" if not retryable else " — no scene change since "
                       "their last failed attempt")
                print(f"finish! (skipped unregisterable views: {sorted(left)}"
                      f"{why})")
                self.skipped_views = sorted(left)
                self.metrics.log(self.it, skipped_views=sorted(left))
                break
            new_id = pdist.on_primary(
                lambda: self.select_next_view(eligible, verbose=verbose))
            print(f"-------------the best view next id is {new_id}--------------")
            if not self.register_view(new_id, verbose=verbose):
                fail_counts[new_id] = fail_counts.get(new_id, 0) + 1
                if max_attempts <= 1:
                    return False    # reference-parity abort
                deferred.add(new_id)
                print(f"[defer] view {new_id} failed registration "
                      f"(attempt {fail_counts[new_id]}/{max_attempts}); "
                      f"requeued")
                continue
            deferred.clear()
            self.it += 1
            self.save_checkpoint(latest=(self.it % int(self.opt.freq.ckpt) != 0))
            if int(self.opt.freq.get("vis", 0)) and self.it % int(self.opt.freq.vis) == 0:
                self._view_artifacts(new_id)
        self._final_artifacts(verbose)
        return True

    def _view_artifacts(self, view_id: int):
        """Per-view artifacts at ``freq.vis``: point cloud, cameras, a
        coarse mesh, and a render of the view when ``freq.vis_render`` is
        set (rank 0). A failure is reported and the run goes on."""
        out = self.opt.get("output_path", None)
        if not out or not pdist.is_primary():
            return
        try:
            from ..utils import export as export_mod
            from ..utils import png
            vis_dir = os.path.join(out, "vis")
            os.makedirs(vis_dir, exist_ok=True)
            export_mod.export_pointcloud(
                self.point_set,
                os.path.join(vis_dir, f"{self.it:04d}_pointcloud.ply"))
            export_mod.export_cameras_json(
                self.camera_set, os.path.join(vis_dir, f"cam{self.it:04d}.json"))
            export_mod.extract_mesh(
                self.params, self.sdf_cfg,
                os.path.join(vis_dir, f"{self.it:04d}_mesh.ply"),
                resolution=int(self.opt.freq.get("vis_mesh_res", 64)),
                grid_boundary=(-0.6, 0.6))
            if int(self.opt.freq.get("vis_render", 0)):
                cam = self.camera_set(view_id)
                img = export_mod.render_full_image(
                    self.params, self.cfgs, cam.pose(), cam.intr,
                    self.cfgs.H, self.cfgs.W)
                png.write_png(os.path.join(vis_dir, f"{self.it:04d}_render.png"),
                              export_mod._u8(img["rgb"]))
                self.metrics.log_image(self.it, "render/rgb", img["rgb"])
                from ..utils import vis as vis_mod
                self.metrics.log_image(self.it, "render/depth",
                                       vis_mod.colorize(img["depth"]))
        except Exception as e:  # artifact dumping must never kill a run
            Log.warn(f"per-view artifact export failed: {e}")

    def _final_artifacts(self, verbose=True):
        """End of the run: the GT-depth evaluation when the scene has GT
        depth, the point cloud, cameras and viewer page, and the timing
        summaries (rank 0). A failure is reported and the run goes on."""
        if not pdist.is_primary():
            return
        if self.var is not None and self.var.get("depth_gt") is not None \
                and len(self.camera_set) >= 2:
            try:
                from ..utils import export as export_mod
                d = export_mod.eval_depth_vs_gt(
                    self.params, self.sdf_cfg, self.camera_set,
                    self.var["depth_gt"], verbose=verbose)
                self.metrics.log(self.it, depth_abs_rel=d["abs_rel"],
                                 depth_rmse=d["rmse"], depth_px=d["n_px"])
            except Exception as e:  # eval must never kill a finished run
                Log.warn(f"depth eval failed: {e}")
        out = self.opt.get("output_path", None)
        if out:
            try:
                from ..utils import export as export_mod
                from ..viz.html_viewer import export_html
                export_mod.export_pointcloud(
                    self.point_set, os.path.join(out, "pointcloud.ply"))
                export_mod.export_cameras_json(
                    self.camera_set, os.path.join(out, "cameras.json"))
                export_html(out)
            except Exception as e:  # artifact dumping must never kill a run
                Log.warn(f"artifact export failed: {e}")
        if verbose and self.timers.totals:
            Log.info("phase timing:", self.timers.summary())
        if verbose and HOST_TIMERS.totals:
            Log.info("host timing:", HOST_TIMERS.summary())
