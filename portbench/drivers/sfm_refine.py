"""The new view's bundle adjustment in ``sfm_refine`` mode: the traffic's
views at their GT poses with the scene's surface points and shared-id
tracks, the fields from the seed's geometric init, and
``Bundler(..., cam_pick_ids=[new view], mode="sfm_refine")``'s
``BAPhase``: one camera, so the pose gradients flow back through the
rendered rays and the encode."""
from __future__ import annotations

import torch


def build(ctx):
    from level_s2fm_tpu_torch.sfm.bundle import Bundler
    from ..harness.cell import PhaseCell, gt_scene, phase_cfgs

    views, new = list(ctx.traffic["views"]), int(ctx.traffic["new_view"])
    cfgs = phase_cfgs(ctx.opt)
    cs, ps, ref = gt_scene(ctx, views)
    b = Bundler(ctx.opt, cfgs, cs, ps, cam_pick_ids=[new], mode="sfm_refine",
                device=ctx.device)
    se3 = torch.as_tensor(cs.all_se3(b.padded_ids)).to(ctx.device)
    params = {"sdf": ctx.params["sdf"], "rad": ctx.params["rad"],
              "se3_r": se3[:, :3].contiguous(), "se3_t": se3[:, 3:].contiguous()}
    state = b.phase.init_state(params, b.xyzs0)
    C = b.batch["images"].shape[0]
    shapes = {"render_rays": min(max(cfgs.rand_rays // C, 1), cfgs.H * cfgs.W) * C,
              "surface_points": int(b.xyzs0.shape[0])}
    return PhaseCell(ctx, b.phase, state, b.batch, "sfm_refine", [new], ref,
                     int(ctx.traffic["occ_every"]), shapes)
