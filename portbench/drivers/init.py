"""The two-view init: ``InitPhase`` on the traffic's pair of views (or the
scene's pose graph's first two), the relative pose estimated from their
matches by the program's essential-matrix RANSAC, and the fields from the
seed's geometric init. ``Initializer(...)`` is built as the engine's
``initialize_two_views`` builds it."""
from __future__ import annotations

import numpy as np


def build(ctx):
    from level_s2fm_tpu_torch.sfm import entities
    from level_s2fm_tpu_torch.sfm.initialization import Initializer
    from ..harness.cell import PhaseCell, phase_cfgs

    var = ctx.scene
    id0, id1 = ctx.traffic.get("views") or [int(v) for v in var["pose_graph"][:2]]
    init_var = {"indx_init": [id0, id1],
                "imgs_init": [var["images"][id0], var["images"][id1]],
                "kypts_init": [var["kypts"][id0], var["kypts"][id1]],
                "intrs_init": [var["intrs"][id0], var["intrs"][id1]],
                "mchs_init": [var["matches"][id0], var["matches"][id1]],
                "inliers_init": [var["masks"][id0], var["masks"][id1]],
                "poses_gt": var["poses_gt"]}
    cfgs = phase_cfgs(ctx.opt)
    cs, ps = entities.CameraSet(), entities.PointSet()
    ini = Initializer(ctx.opt, cfgs, cs, ps, init_var, device=ctx.device)
    state = ini.phase.init_state(ctx.params)

    # the pair's inlier matches, as the benchmark reads them from the scene
    rel = id1 if id1 < id0 else id1 - 1
    m = np.asarray(var["matches"][id0][rel], np.int64)
    inl = np.asarray(var["masks"][id0][rel], bool)
    kp0 = np.asarray(var["kypts"][id0], np.float32)[m[inl, 0]]
    kp1 = np.asarray(var["kypts"][id1], np.float32)[m[inl, 1]]
    ref = {"images": {id0: var["images"][id0], id1: var["images"][id1]},
           "K": np.asarray(var["intrs"][id0], np.float32),
           # the program's estimate of the two poses: the step's fixed input
           "w2c": {c.id: c.pose() for c in cs.cameras},
           "w2c_gt": {c: np.asarray(var["poses_gt"][c], np.float32) for c in (id0, id1)},
           "kp_pair": (kp0, kp1)}
    n_rays = max(cfgs.rand_rays // 2, 1) * 2
    shapes = {"render_rays": n_rays, "surface_points": 0}
    return PhaseCell(ctx, ini.phase, state, ini.batch, "init", [id0, id1], ref,
                     int(ctx.traffic["occ_every"]), shapes)
