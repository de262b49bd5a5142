#!/usr/bin/env python3
"""Rounding spread of the JAX package's tri_trad + ba_trad run, on the CPU.

    python trad_spread.py [--runs=16] [--jobs=3]

Runs the JAX package's traditional-SfM ablation on the synthetic scene,

    python train.py --cpu --yaml=configs/synthetic.yaml --sfm_mode=fast \
        --Ablate_config.tri_trad --Ablate_config.ba_trad --max_views=3

``--runs`` times: run 0 as it stands, run k > 0 with its DLT-triangulated
points scaled by (1 + 1e-7 n), n standard normal from seed k, which is
the size of two float32 implementations' disagreement. The trad BA ends
where Adam's step meets rounding-level gradients along the problem's
gauge freedom, so its final reprojection and pose errors depend on such
perturbations; this script measures how far. Prints one JSON line per
run ({"run", "reproj_px", "rot_err_deg", "t_err", "ate"}: the last global
trad BA's reprojection error and ``eval_poses`` after it) and then the
median and the maximum of each, which ``chip_smoke.py`` holds the port
to. Each run is its own process (``--jobs`` at a time), under
``output/trad_spread/<run>/``.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
ARGS = ["--yaml=configs/synthetic.yaml", "--sfm_mode=fast",
        "--Ablate_config.tri_trad", "--Ablate_config.ba_trad", "--cpu"]
KEYS = ("reproj_px", "rot_err_deg", "t_err", "ate")


def one_run(run: int) -> dict:
    """Run ``run`` in this process and return its final values."""
    import contextlib
    import io

    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    import train as train_mod
    from level_s2fm_tpu.config import build_options
    from level_s2fm_tpu.sfm import hostgeom
    from level_s2fm_tpu.sfm.pipeline import LevelSfM

    dlt = hostgeom.triangulate_dlt
    rng = np.random.default_rng(run)

    def perturbed(*a):
        X = dlt(*a)
        return (X * (1 + 1e-7 * rng.standard_normal(X.shape))).astype(np.float32)

    if run:
        hostgeom.triangulate_dlt = perturbed
    opt = build_options(ARGS + [f"--output_path={REPO}/output/trad_spread/{run}"])
    model = LevelSfM(opt, seed=int(opt.get("seed", 0)))
    model.load_data(train_mod.build_var(opt))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model.train(max_views=3, verbose=True)
    last = [ln for ln in out.getvalue().splitlines() if "global_ba_trad" in ln][-1]
    reproj = float(last.rsplit(":", 1)[1].strip(" }"))
    rot, t_err, ate = model.camera_set.eval_poses(verbose=False)
    return {"run": run, "reproj_px": reproj, "rot_err_deg": float(rot),
            "t_err": float(t_err), "ate": float(ate)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0].startswith("--one="):
        print("RESULT " + json.dumps(one_run(int(argv[0].split("=", 1)[1]))))
        return 0
    runs, jobs = 16, 3
    for a in argv:
        if a.startswith("--runs="):
            runs = int(a.split("=", 1)[1])
        elif a.startswith("--jobs="):
            jobs = int(a.split("=", 1)[1])

    def spawn(run):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), f"--one={run}"],
                           cwd=REPO, capture_output=True, text=True, check=True)
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")][-1]
        return json.loads(line[len("RESULT "):])

    with concurrent.futures.ThreadPoolExecutor(jobs) as ex:
        rows = list(ex.map(spawn, range(runs)))
    for r in rows:
        print(json.dumps(r))
    import numpy as np
    print(json.dumps({"runs": runs,
                      "median": {k: float(np.median([r[k] for r in rows])) for k in KEYS},
                      "max": {k: max(r[k] for r in rows) for k in KEYS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
