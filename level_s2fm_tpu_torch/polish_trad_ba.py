"""Pose polish of a finished run: global trad bundle adjustment.

    python -m level_s2fm_tpu_torch.polish_trad_ba RUN_DIR --yaml=CFG \
        [--cpu] [--cycles=N] [--iters=N] [other option overrides]

Restores ``RUN_DIR/model.ckpt`` (either package's v3 checkpoint), runs N
(default 3) global ``TradBundler`` cycles — free 3D points and se(3)
poses under a pure reprojection loss, ``--iters`` steps each (default
``optim.ba.max_iter``) — and prints the pose errors (rotation, translation,
ATE) and the mean reprojection error before and after each cycle with
its wall time. The polished state goes to ``RUN_DIR/model_polished.ckpt``;
``model.ckpt`` is left as it was. Runs on ``cuda`` unless ``--cpu``.

The neural BA of a long run can stop at the hash SDF's representational
floor; the trad BA has no surface coupling and can polish the final pose
graph further.
"""
from __future__ import annotations

import os
import sys
import time


def main(argv=None):
    """Returns {"before": row, "cycles": [row, ...], "path": str}; a row
    is {"rot_deg", "t_err", "ate", "reproj_px"} (+ "wall_s" per cycle)."""
    argv = sys.argv[1:] if argv is None else argv
    run_dir, cycles, iters, keep = argv[0], 3, None, []
    for a in argv[1:]:
        if a.startswith("--cycles="):
            cycles = int(a.split("=", 1)[1])
        elif a.startswith("--iters="):
            iters = int(a.split("=", 1)[1])
        else:
            keep.append(a)
    import torch
    from .config import build_options
    from .sfm import entities
    from .sfm.pipeline import LevelSfM
    from .sfm.trad import TradBundler
    from .train import build_var
    from .utils import checkpoint as ckpt_mod

    opt = build_options(keep + [f"--output_path={run_dir}"])
    if iters:
        opt.optim.ba.max_iter = iters
    model = LevelSfM(opt, seed=int(opt.get("seed", 0)),
                     device="cpu" if opt.get("cpu", False) else "cuda")
    model.load_data(build_var(opt))
    model.restore_checkpoint()
    model._reload_scene()

    def measure():
        r, t, a = model.camera_set.eval_poses(verbose=False)
        e = entities.mean_reprojection_px(model.camera_set, model.point_set, None)
        return {"rot_deg": r, "t_err": t, "ate": a, "reproj_px": e}

    before = measure()
    print(f"[polish] before: rot {before['rot_deg']:.4f} deg  t "
          f"{before['t_err']:.5f}  ate {before['ate']:.5f}  reproj "
          f"{before['reproj_px']:.3f} px  ({len(model.camera_set)} cams, "
          f"{len(model.point_set)} pts)")
    rows = []
    for c in range(cycles):
        t0 = time.perf_counter()
        b = TradBundler(opt, model.cfgs, model.camera_set, model.point_set,
                        device=model.device)
        model.params, _ = b.run(model.params, model.next_key(), verbose=False)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        row = {**measure(), "wall_s": time.perf_counter() - t0}
        rows.append(row)
        print(f"[polish] cycle {c + 1}: rot {row['rot_deg']:.4f} deg  t "
              f"{row['t_err']:.5f}  ate {row['ate']:.5f}  reproj "
              f"{row['reproj_px']:.3f} px  ({row['wall_s']:.2f} s)")
    path = os.path.join(run_dir, "model_polished.ckpt")
    ckpt_mod.save_checkpoint_sfm(path, model.params, model.camera_set,
                                 model.point_set, it=model.it)
    print("[polish] wrote", path)
    return {"before": before, "cycles": rows, "path": path}


if __name__ == "__main__":
    main()
