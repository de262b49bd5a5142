"""Incremental SfM orchestrator — the two-view start of the engine.

Counterpart of ``LevelSfM`` in ``level_s2fm_tpu/sfm/pipeline.py``:
construction, data loading, the random stream, two-view initialization
and ``train`` up to it. Registration of further views (NBV, PnP,
geoinit, BA, refine), checkpointing and the metric recorder wait for
later slices (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import resolve_device
from ..fields import radiance as radf
from ..fields import sdf as sdf_mod
from ..rendering import renderer as ren_mod
from . import entities
from .initialization import Initializer
from .phases import PhaseCfgs

#: where the registration loop (views 3..N) will come from
REGISTRATION_ITEM = ("ROADMAP.md Queue 1, item 'Registration + geoinit' "
                     "(select_next_view, Registration.pnp / geo_init)")


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
        self.cam_info_reloaded = None
        self.initializer: Optional[Initializer] = None

    def load_data(self, var: Dict):
        """var: kypts, matches, masks, poses_gt, images, intrs, pose_graph."""
        self.var = var

    def next_key(self) -> torch.Generator:
        """A fresh CPU generator, seeded from the engine's stream."""
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.gen))
        return torch.Generator().manual_seed(seed)

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

    def train(self, verbose=True, max_views: Optional[int] = None):
        """Two-view initialization on the first pair of the pose graph.
        Registering more views is not ported yet and raises."""
        pose_graph = list(self.var["pose_graph"])
        n_img = len(self.var["images"])
        if len(pose_graph) <= n_img / 2:
            pose_graph = pose_graph + [j for j in range(n_img) if j not in pose_graph]
        want = n_img if max_views is None else int(max_views)
        if want > 2:
            raise NotImplementedError(
                f"registering views beyond the first two (asked for {want}) "
                f"is not ported yet: see {REGISTRATION_ITEM}")
        if len(self.camera_set) < 2:
            self.initialize_two_views(pose_graph[0], pose_graph[1], verbose=verbose)
