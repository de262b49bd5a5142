"""The refine: ``RefinePhase`` over the traffic's views at their GT poses,
the scene's surface points as the point set and their shared ids as
tracks, the fields from the seed's geometric init. Built through
``sfm/entities.py`` and ``Refiner(...)``."""
from __future__ import annotations


def build(ctx):
    from level_s2fm_tpu_torch.sfm.bundle import Refiner
    from ..harness.cell import PhaseCell, gt_scene, phase_cfgs

    views = list(ctx.traffic["views"])
    cfgs = phase_cfgs(ctx.opt)
    cs, ps, ref = gt_scene(ctx, views)
    r = Refiner(ctx.opt, cfgs, cs, ps, device=ctx.device)
    state = r.phase.init_state(ctx.params)
    C = r.batch["images"].shape[0]
    shapes = {"render_rays": min(max(cfgs.rand_rays // C, 1), cfgs.H * cfgs.W) * C,
              "surface_points": 0}
    return PhaseCell(ctx, r.phase, state, r.batch, "refine", views, ref,
                     int(ctx.traffic["occ_every"]), shapes)
