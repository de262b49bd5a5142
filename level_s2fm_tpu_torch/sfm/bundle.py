"""Neural bundle adjustment and rendering refine: host wrappers.

Counterpart of ``level_s2fm_tpu/sfm/bundle.py``: ``Bundler`` runs one
``BAPhase`` over picked cameras (local: the new camera and its covisible
views; global: all) and writes the poses and the surface-projected
points back; ``Refiner`` runs ``RefinePhase`` with the poses fixed. Both
pad the camera axis to a bucket (``cam_bucket``): the padded slots repeat
camera 0 and are masked out of every loss, and the per-camera ray budget
is rand_rays // padded count, so the batches match the JAX package's.
Phases that render rebuild the occupancy grid between segments
(``run_phase_occ_refresh``). Each run records its optimizer in
``optstate`` and, after a resume, adopts the saved one.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..fields import sdf as sdf_mod
from ..geometry import transforms as T
from ..rendering import raymarch as rm
from . import entities, optstate
from .phases import BAPhase, PhaseCfgs, RefinePhase

#: camera-count buckets of the padded camera axis
_CAM_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def cam_bucket(n: int) -> int:
    for b in _CAM_BUCKETS:
        if n <= b:
            return b
    return int(-(-n // 32) * 32)


def pad_cam_ids(cam_ids: Sequence[int]) -> tuple:
    """(padded id list, real count): padded slots repeat camera 0."""
    ids = list(cam_ids)
    C = len(ids)
    return ids + [ids[0]] * (cam_bucket(C) - C), C


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def build_tracing_data(cfgs: PhaseCfgs, cameraset: entities.CameraSet,
                       pointset: entities.PointSet, cam_ids: Sequence[int],
                       n_real: Optional[int] = None, device=None):
    """Per-camera padded tracked-keypoint rays + target points for the
    multi-view tracing-consistency loss."""
    C = len(cam_ids)
    per_cam = []
    for cid in cam_ids:
        cam = cameraset(cid)
        per_cam.append((cam, np.where(cam.idx2d_to_3d != -1)[0]))
    Nt = entities.pad_to_bucket(max([len(k) for _, k in per_cam] + [1]))
    center = np.zeros((C, Nt, 3), np.float32)
    ray = np.zeros((C, Nt, 3), np.float32)
    ray[..., 2] = 1.0
    xyz = np.zeros((C, Nt, 3), np.float32)
    mask = np.zeros((C, Nt), bool)
    for i, (cam, kidx) in enumerate(per_cam):
        n = len(kidx)
        if n == 0:
            continue
        c, r = T.get_center_and_ray(_t(cam.pose())[None], _t(cam.intr),
                                    _t(cam.kypts[kidx]))
        center[i, :n] = c[0].numpy()
        ray[i, :n] = r[0].numpy()
        xyz[i, :n] = pointset.get_xyzs(cam.idx2d_to_3d[kidx])
        mask[i, :n] = n_real is None or i < n_real
    on = lambda x: torch.as_tensor(x).to(device)  # noqa: E731
    return {"center": on(center), "ray": on(ray), "xyz": on(xyz),
            "mask": on(mask)}


def stack_images(cameraset: entities.CameraSet, cam_ids: Sequence[int],
                 device=None):
    return torch.as_tensor(np.stack(
        [cameraset(c).img.reshape(-1, 3) for c in cam_ids], 0)).to(device)


def _cam_batch(cfgs, cameraset, pointset, cam_ids, device):
    """The camera-axis part of a BA / refine batch, padded to a bucket."""
    padded, n_real = pad_cam_ids(cam_ids)
    cam0 = cameraset(cam_ids[0])
    return padded, {
        "intr": _t(cam0.intr).to(device),
        "images": stack_images(cameraset, padded, device),
        "grid": T.mesh_grid(cfgs.H, cfgs.W, device=device),
        "tracing": build_tracing_data(cfgs, cameraset, pointset, padded,
                                      n_real, device),
        "cam_mask": torch.arange(len(padded), device=device) < n_real,
        "n_real": n_real,
    }


def run_phase_occ_refresh(opt, cfgs, phase, state, batch, gen, n_iters,
                          segments: int = 4):
    """Run a phase in outer segments, rebuilding the occupancy grid from
    the CURRENT SDF between segments (the surface moves during a phase;
    the compaction band must follow it). The optimizer's step count runs
    on across segments."""
    seg = max(n_iters // segments, 1)
    done = 0
    parts = []
    while done < n_iters:
        n = min(seg, n_iters - done)
        b = dict(batch)
        b["occ"] = maybe_build_occ(opt, cfgs, state["params"])
        state, m = phase.run(state, b, gen, n_iters=n)
        parts.append(m)
        done += n
    return state, {k: torch.cat([m[k] for m in parts]) for k in parts[0]}


def maybe_build_occ(opt, cfgs, params):
    """Occupancy grid for compacted rendering (None unless
    Renderer.compact_samples is set)."""
    if cfgs.ren.compact_samples is None:
        return None
    ren = opt.get("Renderer", {})
    table = params["sdf"]["table"]
    return rm.build_occupancy_grid(
        lambda p: sdf_mod.infer_sdf(params["sdf"], cfgs.sdf, p),
        cfgs.sdf.center, cfgs.sdf.half_size,
        resolution=int(ren.get("occ_res", 64)),
        threshold=float(ren.get("occ_threshold", 0.25)), one_sided=True,
        device=table.device)


class Bundler:
    """One BA invocation over picked cameras."""

    def __init__(self, opt, cfgs: PhaseCfgs, cameraset: entities.CameraSet,
                 pointset: entities.PointSet,
                 cam_pick_ids: Optional[List[int]] = None,
                 mode: str = "sfm_refine", device=None):
        self.opt = opt
        self.cfgs = cfgs
        self.cameraset = cameraset
        self.pointset = pointset
        self.local = cam_pick_ids is not None
        self.cam_pick_ids = (list(cam_pick_ids) if cam_pick_ids is not None
                             else list(cameraset.cam_ids))
        self.mode = mode
        ob = opt.optim.ba
        max_iter = int(ob.max_iter)
        if cam_pick_ids is not None and len(cam_pick_ids) == 1:
            max_iter = max_iter // 2
        self.max_iter = max_iter

        pts_id, pose_idx, kypts = entities.gather_track_observations(
            cameraset, self.cam_pick_ids)
        self.pts_pick_ids = pts_id
        P = entities.pad_to_bucket(max(len(pts_id), 1))
        xyzs = np.zeros((P, 3), np.float32)
        xyzs[:len(pts_id)] = pointset.get_xyzs(pts_id)
        kp = np.zeros((P, 2), np.float32)
        kp[:len(pts_id)] = kypts
        pidx = np.zeros(P, np.int64)
        pidx[:len(pts_id)] = pose_idx
        valid = np.zeros(P, bool)
        valid[:len(pts_id)] = True
        self.padded_ids, cams = _cam_batch(cfgs, cameraset, pointset,
                                           self.cam_pick_ids, device)
        on = lambda x: torch.as_tensor(x).to(device)  # noqa: E731
        self.batch = {"pose_idx": on(pidx), "kp": on(kp), "valid": on(valid),
                      **cams}
        self.xyzs0 = on(xyzs)
        self.phase = BAPhase(
            cfgs, dict(opt.loss_weight.ba), mode=mode,
            single_cam=(len(self.cam_pick_ids) == 1),
            lr_sdf=float(ob.lr_sdf), lr_sdf_end=float(ob.lr_sdf_end),
            lr_color=float(ob.lr_color), lr_pose_r=float(ob.lr_pose_r),
            lr_pose_t=float(ob.lr_pose_t), max_iter=max_iter)

    def run(self, params, gen, verbose=True) -> tuple:
        """Returns (params, reproj_px)."""
        dev = self.xyzs0.device
        se3 = self.cameraset.all_se3(self.padded_ids)
        ba_params = {"sdf": params["sdf"], "rad": params["rad"],
                     "se3_r": torch.as_tensor(se3[:, :3]).to(dev),
                     "se3_t": torch.as_tensor(se3[:, 3:]).to(dev)}
        state = self.phase.init_state(ba_params, self.xyzs0)
        state["opt"] = optstate.adopt(f"ba_{self.mode}", state["opt"])
        # the occupancy refresh matters only when the phase renders
        if self.cfgs.ren.compact_samples is not None and self.mode != "sfm":
            state, metrics = run_phase_occ_refresh(
                self.opt, self.cfgs, self.phase, state, self.batch, gen,
                self.max_iter)
        else:
            state, metrics = self.phase.run(state, self.batch, gen)
        optstate.record(f"ba_{self.mode}", state["opt"])
        self.metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        reproj = float(self.metrics["reproj_px"][-1])
        if verbose:
            name = "local_ba" if self.local else "global_ba"
            print({"phase": name, **{k: round(float(v[-1]), 4)
                                     for k, v in self.metrics.items()}})
            print(f"reprojection error{reproj}")
        p = state["params"]
        se3_new = torch.cat([p["se3_r"], p["se3_t"]], dim=1).detach().cpu().numpy()
        for j, cid in enumerate(self.cam_pick_ids):
            self.cameraset(cid).se3 = se3_new[j].copy()
        if not self.opt.Ablate_config.get("replicate_update_xyzs_bug", False):
            xyzs_new = state["xyzs"].cpu().numpy()[:len(self.pts_pick_ids)]
            self.pointset.update_xyzs(self.pts_pick_ids, xyzs_new)
        return {"sdf": p["sdf"], "rad": p["rad"]}, reproj


class Refiner:
    """Rendering refine: poses fixed, fit the fields."""

    def __init__(self, opt, cfgs: PhaseCfgs, cameraset: entities.CameraSet,
                 pointset: entities.PointSet,
                 cam_pick_ids: Optional[List[int]] = None,
                 max_iter: Optional[int] = None, device=None):
        self.opt = opt
        self.cfgs = cfgs
        self.cameraset = cameraset
        self.cam_pick_ids = (list(cam_pick_ids) if cam_pick_ids is not None
                             else list(cameraset.cam_ids))
        orf = opt.optim.refine
        padded, cams = _cam_batch(cfgs, cameraset, pointset, self.cam_pick_ids,
                                  device)
        poses, _ = cameraset.all_poses(padded)
        self.batch = {"poses": torch.as_tensor(poses).to(device), **cams}
        self.phase = RefinePhase(
            cfgs, dict(opt.loss_weight.refine),
            lr_sdf=float(orf.lr_sdf), lr_sdf_end=float(orf.lr_sdf_end),
            lr_color=float(orf.lr_color),
            max_iter=int(max_iter or orf.max_iter))

    def run(self, params, gen, verbose=True):
        state = self.phase.init_state(params)
        state["opt"] = optstate.adopt("refine", state["opt"])
        if self.cfgs.ren.compact_samples is not None:
            state, metrics = run_phase_occ_refresh(
                self.opt, self.cfgs, self.phase, state, self.batch, gen,
                self.phase.max_iter)
        else:
            state, metrics = self.phase.run(state, self.batch, gen)
        optstate.record("refine", state["opt"])
        self.metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        if verbose:
            print({"phase": "refine", **{k: round(float(v[-1]), 4)
                                         for k, v in self.metrics.items()}})
        return state["params"]
