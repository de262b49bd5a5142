"""What every phase driver shares: the run's context, the program's
phase configuration, the scene's cameras and points, and the stepping of
one phase with its occupancy-grid refresh.

A driver (``portbench/drivers/<name>.py``) defines ``build(ctx)``, which
builds one phase of the program from ``ctx`` and returns a ``PhaseCell``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ..reference import step as ref_step


@dataclasses.dataclass
class Context:
    """What a driver builds from: the options (the port's ``Opt``), the
    scene (``scenes.load``), the initial parameters (``weights.make``),
    the cell's traffic parameters, the seed and the device."""
    opt: Any
    scene: Dict
    params: Dict
    traffic: Dict
    seed: int
    device: torch.device


def phase_cfgs(opt):
    """The program's static phase configuration, as its engine builds it."""
    from level_s2fm_tpu_torch.fields import radiance as radf
    from level_s2fm_tpu_torch.fields import sdf as sdf_mod
    from level_s2fm_tpu_torch.rendering import renderer as ren_mod
    from level_s2fm_tpu_torch.sfm.phases import PhaseCfgs
    H, W = opt.data.image_size
    in_list = opt.data.get("dataset", None) in [
        "TanksAndTemple", "BlendedMVS", "scannet", "DTU", "llff", "ETH3D", "ETH3D_sp",
        None, "synthetic"]
    return PhaseCfgs(sdf=sdf_mod.config_from_opt(opt), rad=radf.config_from_opt(opt),
                     ren=ren_mod.config_from_opt(opt), H=H, W=W,
                     rand_rays=int(opt.Renderer.rand_rays),
                     dc_unfinish_weight=None if in_list else opt.data.get("unfinish_dc"))


def gt_scene(ctx, cam_ids):
    """The program's CameraSet and PointSet with the cameras ``cam_ids``
    at their GT poses and the scene's surface points, each tracked by the
    keypoints that see it; and the same scene for the reference."""
    from level_s2fm_tpu_torch.sfm import entities
    var = ctx.scene
    se3 = ref_step.pose_to_se3(torch.as_tensor(var["poses_gt"])).numpy()
    cs, ps = entities.CameraSet(), entities.PointSet()
    tracks = [[] for _ in range(len(var["surface_pts"]))]
    for pos, c in enumerate(cam_ids):
        for k, p in enumerate(var["vis_ids"][c]):
            tracks[p].append((pos, k))
        cs.add(entities.Camera(
            id=c, img=np.asarray(var["images"][c], np.float32),
            intr=np.asarray(var["intrs"][c], np.float32),
            pose_gt=np.asarray(var["poses_gt"][c], np.float32),
            kypts=np.asarray(var["kypts"][c], np.float32), matches=var["matches"][c],
            inlier_masks=var["masks"][c], se3=se3[c],
            idx2d_to_3d=np.asarray(var["vis_ids"][c], np.int64)))
    ps.add_points(var["surface_pts"], tracks)
    ref = {"images": {c: var["images"][c] for c in cam_ids},
           "K": np.asarray(var["intrs"][cam_ids[0]], np.float32),
           "kypts": {c: np.asarray(var["kypts"][c], np.float32) for c in cam_ids},
           "idx2d": {c: np.asarray(var["vis_ids"][c], np.int64) for c in cam_ids},
           "xyz": ps.all_xyzs().copy(), "se3": {c: se3[c] for c in cam_ids}}
    return cs, ps, ref


class PhaseCell:
    """One phase of the program, stepped as its engine steps it: the
    occupancy grid is rebuilt from the current SDF before every
    ``occ_every``-th step (``bundle.run_phase_occ_refresh``'s segments).

    ``kind``, ``cam_ids`` and ``ref_scene`` tell the reference what to
    follow; ``max_iter`` sets the phase's learning-rate decay.
    """

    def __init__(self, ctx: Context, phase, state, batch, kind: str,
                 cam_ids: List[int], ref_scene: Dict, occ_every: int,
                 flop_shapes: Dict):
        from level_s2fm_tpu_torch.sfm import bundle
        self._occ = lambda p: bundle.maybe_build_occ(ctx.opt, phase.cfgs, p)
        self.phase, self.state, self.batch = phase, state, dict(batch)
        self.kind, self.cam_ids, self.ref_scene = kind, cam_ids, ref_scene
        self.occ_every, self.max_iter = occ_every, phase.max_iter
        #: the step's shapes the FLOP count reads (``harness.flops``)
        self.flop_shapes = flop_shapes
        self.gen = torch.Generator().manual_seed(ctx.seed)
        self.i = 0

    def step(self):
        """One step of the phase; returns its metrics (device tensors)."""
        if self.i % self.occ_every == 0:
            self.batch["occ"] = self._occ(self.state["params"])
        out = self.phase.step(self.state, self.batch, self.gen)
        self.i += 1
        return out

    def leaves(self):
        """{dotted path: tensor} of the optimised parameters."""
        opt = self.state["opt"]
        ids = {id(p) for p in opt.leaves}
        return {k: v for k, v in ref_step.leaves(self.state["params"]).items()
                if id(v) in ids}

    def moments(self):
        """{dotted path: the optimizer's first moment} of the optimised
        parameters."""
        opt = self.state["opt"]
        by_id = {id(p): m for p, m in zip(opt.leaves, opt.mu)}
        return {k: by_id[id(v)] for k, v in self.leaves().items()}
