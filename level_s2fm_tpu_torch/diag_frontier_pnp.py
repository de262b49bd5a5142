"""Frontier PnP threshold sweep: why are the remaining views failing?

    python -m level_s2fm_tpu_torch.diag_frontier_pnp RUN_DIR \
        --yaml=configs/<cfg>.yaml [--cpu] [overrides...]

The port's counterpart of ``scripts/diag_frontier_pnp.py``. For every
unregistered view of a checkpointed run directory (``RUN_DIR/model.ckpt``,
written by either package), it rebuilds the 2D-3D pairs as
``Registration.pnp`` does (``get_pairs`` and the SDF gate) and prints the
RANSAC inlier counts at the pixel gates 1.5 / 2 / 2.5 / 3 / 4, one line a
view: ``view pairs gated in@1.5px ...``. Reading the output:

- counts GROW with the gate  -> the 3D points are displaced (SDF drift /
  grazing triangulations); consider a wider ``optim.pnp_max_error_px``.
- counts SATURATE            -> the non-inlier pairs are wrong
  correspondences; the pose is supported by the saturated count, and
  the ``registration.min_inliers`` / ``min_inlier_ratio`` floors should
  be judged against THAT number.

The SDF gate is the pipeline's (``registration._sdf_gate``: 0.05, and
5000 under ``Ablate_config.ba_trad``), where the JAX script keeps 0.05.
The SDF is evaluated on the card unless ``--cpu`` is given.
"""
from __future__ import annotations

import sys

GATES = (1.5, 2.0, 2.5, 3.0, 4.0)


def sweep(run_dir, overrides=()):
    """The restored run's registered and unregistered views, and one row
    {view, pairs, gated, inliers (one count per gate, None without
    pairs)} for each unregistered view."""
    import numpy as np
    from .config import build_options
    from .fields import sdf as sdf_mod
    from .sfm import hostgeom
    from .sfm.pipeline import LevelSfM
    from .sfm.registration import Registration, _sdf_gate
    from .train import build_var
    opt = build_options(list(overrides) + [f"--output_path={run_dir}", "--resume"])
    device = "cpu" if opt.get("cpu", False) else "cuda"
    model = LevelSfM(opt, seed=int(opt.get("seed") or 0), device=device)
    model.load_data(build_var(opt))
    model.restore_checkpoint()
    model._reload_scene()
    registered = sorted(int(c) for c in model.camera_set.cam_ids)
    left = [v for v in range(len(model.var["images"])) if v not in registered]
    gate = _sdf_gate(opt)
    rows = []
    for vid in left:
        cam_new = model._make_camera(vid)
        reg = Registration(opt, model.cfgs, model.camera_set)
        pairs = reg.get_pairs(cam_new, model.point_set)
        if pairs is None:
            rows.append({"view": vid, "pairs": 0, "gated": 0, "inliers": None})
            continue
        p3d, p2d, _, _ = pairs
        sdfs = sdf_mod.infer_sdf_host(model.params["sdf"], model.cfgs.sdf, p3d)
        mask = sdfs < gate
        p3d_m, p2d_m = p3d[mask], p2d[mask]
        counts = []
        for thr in GATES:
            res = hostgeom.pnp_ransac(p2d_m, p3d_m, cam_new.intr, max_error_px=thr)
            counts.append(int(np.sum(res.inliers)) if res.success else 0)
        rows.append({"view": vid, "pairs": len(p3d), "gated": int(mask.sum()),
                     "inliers": counts})
    return {"registered": registered, "unregistered": left, "sdf_gate": gate,
            "device": device, "rows": rows}


def format_row(row) -> str:
    """The JAX script's line for a row."""
    cols = (["-"] * len(GATES) if row["inliers"] is None
            else [str(n) for n in row["inliers"]])
    return f"{row['view']} {row['pairs']} {row['gated']} " + " ".join(cols)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    out = sweep(argv[0], argv[1:])
    print("registered cams:", out["registered"])
    print("unregistered:", out["unregistered"])
    if out["rows"]:
        print("view pairs gated " + " ".join(f"in@{g}px" for g in GATES))
        for row in out["rows"]:
            print(format_row(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
