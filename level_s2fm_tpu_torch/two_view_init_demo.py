"""Two-view initialization demo: the reference notebook as a module.

    python -m level_s2fm_tpu_torch.two_view_init_demo [--cpu] [--iters 200]
        [--out output/two_view_demo] [overrides...]

The port's counterpart of ``examples/two_view_init_demo.py``, on the card
unless ``--cpu`` is given: it runs the two-view initialization of
``configs/synthetic.yaml`` alone (two 64x64 views of the synthetic
sphere, 256 points, ``--optim.init.max_iter`` = ``--iters``), prints the
pose errors, and writes into the run's output path the triangulated
cloud (``init_points.ply``), the match picture (``matches.png``), five
renders slerped between the two cameras (``slerp_<i>.png``) and their
animation (``slerp.gif``). Further ``--dot.path=value`` arguments
override the config, as in ``train``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default="output/two_view_demo")
    args, overrides = ap.parse_known_args(argv)
    import torch
    from .config import build_options
    from .data import synthetic
    from .geometry import lie
    from .sfm.pipeline import LevelSfM
    from .utils import export as export_mod
    from .utils import gif, png, vis

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the GPU, or pass --cpu")
    opt = build_options(overrides + [f"--optim.init.max_iter={args.iters}",
                                     f"--output_root={args.out}"],
                        yaml_path=os.path.join(REPO, "configs", "synthetic.yaml"))
    scene = synthetic.make_scene(n_views=2, H=64, W=64, n_points=256, seed=0)
    model = LevelSfM(opt, seed=0, device="cpu" if args.cpu else "cuda")
    model.load_data(synthetic.scene_to_var(scene))
    model.initialize_two_views(0, 1)
    rot_err, t_err = model.initializer.pose_errors[:2]

    out_dir = opt.output_path
    os.makedirs(out_dir, exist_ok=True)
    written = [os.path.join(out_dir, "init_points.ply")]
    export_mod.export_pointcloud(model.point_set, written[-1])
    cam0, cam1 = model.camera_set.cameras
    i0, i1 = cam0.matched_kypt_ids(cam1.id)
    written.append(os.path.join(out_dir, "matches.png"))
    vis.draw_matches(cam0.img, cam1.img, cam0.kypts[i0], cam1.kypts[i1],
                     written[-1], vis_num=100)
    p0 = torch.as_tensor(cam0.pose())
    p1 = torch.as_tensor(cam1.pose())
    frames = []
    for i, t in enumerate(np.linspace(0, 1, 5)):
        pose_t = lie.slerp_pose(p0, p1, float(t)).numpy()
        img = export_mod.render_full_image(model.params, model.cfgs, pose_t,
                                           cam0.intr, model.cfgs.H, model.cfgs.W,
                                           ray_batch=4096)
        frames.append((np.clip(img["rgb"], 0, 1) * 255).astype(np.uint8))
        written.append(os.path.join(out_dir, f"slerp_{i}.png"))
        png.write_png(written[-1], frames[-1])
    written.append(os.path.join(out_dir, "slerp.gif"))
    gif.write_gif(written[-1], np.stack(frames), fps=4, loop=0)
    print({"rot_error_deg": float(rot_err), "t_error_deg": float(t_err),
           "n_points": len(model.point_set)})
    print(f"demo artifacts in {out_dir}: "
          + ", ".join(os.path.basename(p) for p in written))
    return {"rot_error_deg": float(rot_err), "t_error_deg": float(t_err),
            "out_dir": out_dir, "written": written}


if __name__ == "__main__":
    main()
    sys.exit(0)
