"""CLI entry of the port: incremental neural SfM on the GPU.

    python -m level_s2fm_tpu_torch.train --yaml=configs/<cfg>.yaml \
        [--sfm_mode=fast] [--max_views=N] [--output_path=DIR] [--cpu]
        [--resume | --load=CKPT] [--get_result [--refine_again]
        [--refine_again_iters=N]]

Same options as the JAX package's ``train.py`` (dot-path overrides,
``--flag`` / ``--flag!``). Runs on ``cuda`` unless ``--cpu`` is given and
raises when no GPU is there. The scene is the synthetic sphere
(``data.dataset: synthetic``, built from ``--seed``) or a prepared scene
of any dataset in ``data.loaders.LOADERS`` (DTU, ETH3D, BlendedMVS,
ScanNet). Writes ``options.yaml``, ``metrics.jsonl`` and the checkpoints
under ``output_path`` (default ``output_root/group/name``).

- A run: ``LevelSfM.train`` — the two-view initialization, then every
  further view (up to ``--max_views``) through PnP, geoinit, the BA
  cycles and, in ``full`` mode, the rendering refine; with
  ``Ablate_config.refine_again`` a final refine over all views follows.
- ``--resume`` restores ``output_path/model.ckpt`` (parameters, cameras,
  points, the last phase's optimizer state) and goes on registering;
  ``--load=CKPT`` restores another checkpoint the same way.
- ``--get_result`` restores the checkpoint, optionally refines again over
  every camera (``--refine_again``, ``--refine_again_iters``, default
  10000) and saves it, then writes the results (``export_results``: mesh,
  point cloud, cameras, COLMAP model, viewer page, a render).

Prints the init summary, one metrics row per registered view and a final
summary with the registered and skipped views.
"""
from __future__ import annotations

import os
import sys
import time


def build_var(opt):
    """The scene as the pipeline's ``var`` dict."""
    if opt.data.get("dataset") == "synthetic":
        from .data import synthetic
        scene = synthetic.make_scene(
            n_views=int(opt.data.get("n_views", 4)),
            H=opt.data.image_size[0], W=opt.data.image_size[1],
            n_points=int(opt.data.get("n_points", 256)),
            seed=int(opt.get("seed", 0)))
        return synthetic.scene_to_var(scene)
    from .data import loaders
    return loaders.load_prepared_scene(opt)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from .config import build_options, save_options_file
    opt = build_options(argv)
    os.makedirs(opt.output_path, exist_ok=True)
    save_options_file(opt)
    return _run(opt)


def _run(opt):
    from .sfm.bundle import Refiner
    from .sfm.pipeline import LevelSfM
    device = "cpu" if opt.get("cpu", False) else "cuda"
    model = LevelSfM(opt, seed=int(opt.get("seed", 0)), device=device)
    model.load_data(build_var(opt))
    if opt.get("resume", False) or opt.get("get_result", False):
        # --get_result needs a checkpoint: restore it without --resume
        model.restore_checkpoint()
    elif opt.get("load", None):
        model.restore_checkpoint(opt.load)

    if opt.get("get_result", False):
        from .utils import export
        model._reload_scene()
        if opt.get("refine_again", None) or opt.Ablate_config.get("refine_again"):
            refiner = Refiner(opt, model.cfgs, model.camera_set, model.point_set,
                              max_iter=int(opt.get("refine_again_iters", 10000)),
                              device=model.device)
            model.params = refiner.run(model.params, model.next_key())
            model.save_checkpoint(latest=True)
        export.export_results(opt, model)
        return model

    max_views = opt.get("max_views", None)
    t0 = time.time()
    ok = model.train(max_views=int(max_views) if max_views else None)
    init = model.initializer
    if init is not None and getattr(init, "_metrics", None) is not None:
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
