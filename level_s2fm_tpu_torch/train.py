"""CLI entry of the port: incremental neural SfM on the GPU.

    python -m level_s2fm_tpu_torch.train --yaml=configs/synthetic.yaml \
        [--sfm_mode=fast] [--max_views=N] [--cpu]

Same options as the JAX package's ``train.py`` (dot-path overrides,
``--flag`` / ``--flag!``). Runs on ``cuda`` unless ``--cpu`` is given and
raises when no GPU is there. Builds the synthetic scene from ``--seed``
and runs ``LevelSfM.train``: the two-view initialization, then every
further view (up to ``--max_views``) through PnP, geoinit, the BA cycles
and, in ``full`` mode, the rendering refine. With
``Ablate_config.refine_again`` a final refine over all views follows.
Prints the init summary, one metrics row per registered view and a final
summary with the registered and skipped views.
"""
from __future__ import annotations

import sys
import time


def build_var(opt):
    """The synthetic scene as the pipeline's ``var`` dict."""
    if opt.data.get("dataset") != "synthetic":
        raise NotImplementedError(
            "only the synthetic scene is ported; the prepared-dataset loaders "
            "wait (ROADMAP Queue 1)")
    from .data import synthetic
    scene = synthetic.make_scene(
        n_views=int(opt.data.get("n_views", 4)),
        H=opt.data.image_size[0], W=opt.data.image_size[1],
        n_points=int(opt.data.get("n_points", 256)),
        seed=int(opt.get("seed", 0)))
    return synthetic.scene_to_var(scene)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from .config import build_options
    from .sfm.bundle import Refiner
    from .sfm.pipeline import LevelSfM
    opt = build_options(argv)
    device = "cpu" if opt.get("cpu", False) else "cuda"
    model = LevelSfM(opt, seed=int(opt.get("seed", 0)), device=device)
    model.load_data(build_var(opt))
    max_views = opt.get("max_views", None)
    t0 = time.time()
    ok = model.train(max_views=int(max_views) if max_views else None)
    init = model.initializer
    m = init._metrics
    print({"init_losses_first": {k: float(v[0]) for k, v in m.items()},
           "init_losses_last": {k: float(v[-1]) for k, v in m.items()},
           "steps": int(len(m["all"])), "triangulated": init.tri_ratio,
           "rot_error_deg": init.pose_errors[0],
           "t_error_deg": init.pose_errors[1]})
    if ok and opt.Ablate_config.get("refine_again", False):
        r = Refiner(opt, model.cfgs, model.camera_set, model.point_set,
                    device=model.device)
        model.params = r.run(model.params, model.next_key())
    rot, t_err, ate = model.camera_set.eval_poses(verbose=False)
    print({"ok": bool(ok), "registered": list(model.camera_set.cam_ids),
           "skipped_views": model.skipped_views,
           "n_points": len(model.point_set),
           "reproj_px": model.view_log[-1]["reproj_px"] if model.view_log else None,
           "rot_error_deg": rot, "t_error": t_err, "ate": ate,
           "seconds": round(time.time() - t0, 3), "device": str(model.device)})
    return model


if __name__ == "__main__":
    main()
