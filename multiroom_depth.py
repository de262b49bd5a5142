"""How deep phase parallel (c) of ``chip_smoke.py`` must run for the
multiroom view 3 to converge, and what rounding alone does to it.

    python3 multiroom_depth.py [--init-worlds]

Runs ``configs/scannet_multiroom_synth.yaml`` (fast mode, 3 views) on one
GPU, each run under deterministic algorithms or, where named ``_nondet``,
with the card's float atomics (a run that differs from the deterministic
one by rounding only): the init at 300 steps at one rank, both ways;
then, from the deterministic init's checkpoint, view 3 at one rank at
geoinit 20 / BA 50 (both ways), geoinit 100 / BA 50 and geoinit 100 /
BA 200; then view 3 at two ranks sharing the card over gloo at geoinit
20 / BA 50. With ``--init-worlds`` it runs only the init at 300 steps,
at one rank and at two ranks sharing the card, both deterministic.
Prints one ``[x]`` line
per run (final reprojection, Procrustes rotation, t_err, ATE, points,
the camera pairs' relative rotations, wall and stage seconds) and writes
them to ``output/multiroom_depth/results.json``.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()


def rank_fn(argv):
    import torch
    from level_s2fm_tpu_torch import train
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    r = train._rank_run(argv)
    torch.cuda.synchronize()
    r["wall_s"] = time.perf_counter() - t0
    return r


def row(cs, summary, view_log, se3, pose_gt):
    rel = cs._rel_rot_deg(se3, pose_gt) if len(se3) >= 3 else None
    return {"reproj_px": summary["reproj_px"], "rot": summary["rot_error_deg"],
            "t": summary["t_error"], "ate": summary["ate"],
            "n_points": summary["n_points"], "rel": rel,
            "stage_s": [v["stage_s"] for v in view_log], "n_ba": len(view_log)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init-worlds", action="store_true",
                    help="only the init, at one rank and at two ranks")
    init_worlds = ap.parse_args().init_worlds
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import numpy as np
    import torch
    import chip_smoke as cs
    from level_s2fm_tpu_torch import train
    from level_s2fm_tpu_torch.parallel import distributed as pdist
    if not torch.cuda.is_available():
        print("multiroom_depth: needs a CUDA device", file=sys.stderr)
        return 2
    cs.phase_build()
    base = ["--yaml=configs/scannet_multiroom_synth.yaml", "--sfm_mode=fast",
            "--max_views=3"]
    out_root = os.path.join("output", "multiroom_depth")
    res, pose_gt = {}, {}

    def one(name, argv, det=True):
        t0 = time.perf_counter()
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            m = train.main(base + argv + ["--parallel.data_devices=1",
                                          "--output_path=" + os.path.join(out_root, name)])
        finally:
            torch.use_deterministic_algorithms(False)
        torch.cuda.synchronize()
        out = {"wall_s": time.perf_counter() - t0, "n_points": len(m.point_set)}
        init = m.initializer
        if init is not None and getattr(init, "_metrics", None):
            out["init_last"] = {k: float(v[-1]) for k, v in init._metrics.items()}
            out["triangulated"] = list(init.tri_ratio)
        if getattr(m, "summary", None):
            pose_gt[name] = np.stack([c.pose_gt for c in m.camera_set.cameras])
            out.update(row(cs, m.summary, m.view_log, m.camera_set.all_se3(),
                           pose_gt[name]))
            out["timers"] = dict(m.timers.totals)
        res[name] = out
        print(f"[x] {name} " + json.dumps(out, default=str), flush=True)
        return m

    def view3(g, b):
        return ["--load=" + os.path.join(out_root, "init300", "model.ckpt"),
                f"--optim.geoinit.max_iter={g}", f"--optim.ba.max_iter={b}"]

    one("init300", ["--max_views=2", "--optim.init.max_iter=300"])
    if init_worlds:
        argv = base + ["--max_views=2", "--optim.init.max_iter=300",
                       "--output_path=" + os.path.join(out_root, "init300_r2")]
        t0 = time.perf_counter()
        ranks = pdist.launch(rank_fn, ["cuda:0", "cuda:0"], "gloo", args=(argv,))
        r = ranks[0]
        res["init300_r2"] = {
            "launch_s": time.perf_counter() - t0, "wall_s": r["wall_s"],
            "equal": len({x["params_digest"] for x in ranks}) == 1,
            "n_points": r["summary"]["n_points"], "init_last": r["init_last"],
            "rot": r["summary"]["rot_error_deg"], "t": r["summary"]["t_error"]}
        print("[x] init300_r2 " + json.dumps(res["init300_r2"], default=str), flush=True)
        return _write(res)
    one("init300_nondet", ["--max_views=2", "--optim.init.max_iter=300"], det=False)
    one("v3_g20_b50", view3(20, 50))
    one("v3_g20_b50_nondet", view3(20, 50), det=False)
    one("v3_g100_b50", view3(100, 50))
    one("v3_g100_b200", view3(100, 200))
    for name, g, b, ref in [("r2_g20_b50", 20, 50, "v3_g20_b50")]:
        argv = base + view3(g, b) + ["--output_path=" + os.path.join(out_root, name)]
        t0 = time.perf_counter()
        ranks = pdist.launch(rank_fn, ["cuda:0", "cuda:0"], "gloo", args=(argv,))
        r = ranks[0]
        out = {"launch_s": time.perf_counter() - t0, "wall_s": r["wall_s"],
               "equal": len({x["params_digest"] for x in ranks}) == 1}
        out.update(row(cs, r["summary"], r["view_log"], r["se3"], pose_gt[ref]))
        res[name] = out
        print(f"[x] {name} " + json.dumps(out, default=str), flush=True)
    return _write(res)


def _write(res):
    print(f"[t] {time.time() - T0:.1f} s", flush=True)
    path = os.path.join(REPO, "output", "multiroom_depth", "results.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, default=str, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
